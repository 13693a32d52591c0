// linear_q8: y = (x8 . w8^T) * s_row * s_col + b with int8 operands and an
// int32 sum, then one of three epilogues: bf16 out (Q/K/V), exact GELU kept
// in f32 (the FFN hidden, which the next quantisation reads in f32), or
// bf16 then "+ residual" in bf16 (output projections, FFN second product).
//
// Replaces _qdot8 / _qdot (mixermdm_tpu/ops/fused_block.py:66-77), the int8
// MXU products of the q8 Pallas block kernels (_sa_block_kernel_q8,
// _ca_block_kernel_q8, _ffn_kernel_q8).  The TPU kernels hold the whole int8
// E x E weight in VMEM; here it streams.  At the denoiser shapes (M = rows * T
// ~ 2.4k, N and K 512-3072) the work is bound by int8 tensor-core operations
// (1979 TOP/s dense on an H100 SXM), which only wgmma reaches.  So the kernel
// is linear_epilogue's Hopper main loop (gemm_sm90.cuh) with the int8 wgmma,
// m64nBNk32.s32.s8.s8: TMA loads of 128-byte K slabs (128 int8) with the
// 128-byte swizzle into a 4-6 stage mbarrier ring, one producer warp, two
// consumer warpgroups, a persistent grid, and the epilogue staged through
// shared memory into coalesced 16-byte stores, which matters most for the
// 4-byte GELU output (M x 2048 x 4 B at the FFN).  Both operands are K-major
// (torch's (N, K) weight layout), the only form int8 wgmma takes.  The row
// strides must be multiples of 16 bytes (the wrapper copies otherwise); the
// ragged M, N and K edges are zero-filled by TMA.
//
// The sum cannot overflow: |acc| <= 127^2 * K = 3.3e7 at K = 2048, and int32
// sums are exact in any order.  The dequantisation is the JAX package's,
// float(acc) * s_row * s_col + b in f32 in that order, each step rounded on its
// own (__fmul_rn / __fadd_rn keep nvcc from contracting it into an FMA), so a
// bf16 output equals the plain version's bit for bit.
#include "gemm_sm90.cuh"

// x8: (M, K) int8 row stride ldx, x_scale: (M,) f32; w8: (N, K) int8 row
// stride ldw, w_scale: (N,) f32; bias: (N,) bf16 or null; res: (M, N) bf16
// row stride ldr (epilogue 2 only); y: (M, N) row stride ldy, bf16
// (epilogues 0 and 2) or f32 (epilogue 1).  epilogue: 0 bf16, 1 exact GELU
// in f32, 2 bf16 + residual.  ldx and ldw multiples of 16, 16-byte aligned
// operands (checked by the Python wrapper); bn, stages, grid and smem from the
// host planner (ops/linear.py: gemm_plan).
extern "C" int mm_linear_q8(const void* x8, long long ldx, const void* x_scale, const void* w8,
                            long long ldw, const void* w_scale, const void* bias,
                            const void* res, long long ldr, void* y, long long ldy, int M, int N,
                            int K, int epilogue, int bn, int stages, int grid, int smem,
                            void* stream) {
  using mm::sm90::kGelu;
  using mm::sm90::kPlain;
  using mm::sm90::kResidual;
  if (epilogue != kPlain && epilogue != kGelu && epilogue != kResidual)
    return static_cast<int>(cudaErrorInvalidValue);
  mm::sm90::GemmArgs a{};
  a.bias = static_cast<const mm::bf16*>(bias);
  a.res = static_cast<const mm::bf16*>(res);
  a.ldr = ldr;
  a.y = y;
  a.ldy = ldy;
  a.sx = static_cast<const float*>(x_scale);
  a.sw = static_cast<const float*>(w_scale);
  a.M = M;
  a.N = N;
  a.K = K;
  a.epi = epilogue;
  // The GELU epilogue writes the f32 hidden that the next quantisation reads.
  a.vec_y = mm::sm90::rows_aligned16(y, ldy, epilogue == kGelu ? 4 : 2);
  a.vec_r = epilogue == kResidual ? mm::sm90::rows_aligned16(res, ldr, 2) : 0;
  a.tiles_m = (M + mm::sm90::BM - 1) / mm::sm90::BM;
  a.tiles_n = (N + bn - 1) / bn;
  a.stages = stages;
  return mm::sm90::launch<int>(CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x8, ldx, w8, ldw, a, bn, grid,
                               smem, static_cast<cudaStream_t>(stream));
}

// Once, when the library loads: the shared memory limit of every tile width.
extern "C" int mm_linear_q8_init() { return mm::sm90::set_smem_limits<int>(); }
