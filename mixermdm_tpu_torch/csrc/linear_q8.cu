// linear_q8: y = (x8 . w8^T) * s_row * s_col + b with int8 operands and an
// int32 sum, then one of four epilogues: bf16 out (Q/K/V), exact GELU kept
// in f32, bf16 then "+ residual" in bf16 (output projections, FFN second
// product), or (mm_linear_q8_gelu_q8, the W8A8 FFN's first product) exact
// GELU quantised per row to int8 in the epilogue, _quant_act of the hidden
// (mixermdm_tpu/ops/fused_block.py:58), by clusters of the N-tiles of a row
// block (gemm_gelu_q8_kernel in gemm_sm90.cuh).
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

namespace {

using mm::sm90::gemm_gelu_q8_kernel;
using mm::sm90::kGeluQ8BN;

// The quantising GELU product is launched as clusters of tiles_n CTAs (the
// N-tiles of one row block, at most 16: the non-portable size, allowed once
// at load time): cudaLaunchKernelEx with a cluster dimension.  A refused
// launch (a cluster the card cannot place) returns its error.
template <int NC>
cudaLaunchConfig_t gelu_q8_config(const mm::sm90::GemmArgs& a, int clusters, int smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * a.tiles_n, 1, 1);
  cfg.blockDim = dim3(128 * (NC + 1), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.tiles_n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int NC>
int launch_gelu_q8(const CUtensorMap& tx, const CUtensorMap& tw, const mm::sm90::GemmArgs& a,
                   int clusters, int smem, cudaStream_t stream) {
  using namespace mm::sm90;
  if (a.stages < 2 || smem < gelu_q8_smem_bytes(NC, kGeluQ8BN, a.stages) || smem > kSmemLimit ||
      clusters < 1 || a.tiles_n < 1 || a.tiles_n > kMaxClusterCtas)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gelu_q8_config<NC>(a, clusters, smem, stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, gemm_gelu_q8_kernel<kGeluQ8BN, NC>, tx, tw, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <int NC>
int max_clusters_gelu_q8(int cluster_ctas, int smem) {
  mm::sm90::GemmArgs a{};
  a.tiles_n = cluster_ctas;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gelu_q8_config<NC>(a, 1, smem, nullptr, &attr);
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, gemm_gelu_q8_kernel<kGeluQ8BN, NC>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

template <int NC>
cudaError_t set_gelu_q8_attributes() {
  const cudaError_t e = cudaFuncSetAttribute(gemm_gelu_q8_kernel<kGeluQ8BN, NC>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             mm::sm90::kSmemLimit);
  return e != cudaSuccess ? e
                          : cudaFuncSetAttribute(gemm_gelu_q8_kernel<kGeluQ8BN, NC>,
                                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

}  // namespace

// h8 = quant_rows(gelu(x8 . w8^T * s_row * s_col + b)) and its row scales
// hs, without the f32 hidden (epilogue kGeluQ8).  x8, x_scale, w8, w_scale,
// bias as for mm_linear_q8; y: (M, N) int8 row stride ldy; ys: (M,) f32.
// Tiles of 128 columns, ceil(N / 128) <= 16 CTAs per cluster; nc consumer
// warpgroups (BM = 64 nc) in {1, 2, 3}, stages and clusters (the row blocks
// walked at once) from the host plan (ops/linear_q8.py: gelu_q8_plan).
extern "C" int mm_linear_q8_gelu_q8(const void* x8, long long ldx, const void* x_scale,
                                    const void* w8, long long ldw, const void* w_scale,
                                    const void* bias, void* y, long long ldy, void* ys, int M,
                                    int N, int K, int nc, int stages, int clusters, int smem,
                                    void* stream) {
  using namespace mm::sm90;
  GemmArgs a{};
  a.bias = static_cast<const mm::bf16*>(bias);
  a.y = y;
  a.ldy = ldy;
  a.ys = static_cast<float*>(ys);
  a.sx = static_cast<const float*>(x_scale);
  a.sw = static_cast<const float*>(w_scale);
  a.M = M;
  a.N = N;
  a.K = K;
  a.epi = kGeluQ8;
  a.vec_y = rows_aligned16(y, ldy, 1);
  a.tiles_m = (M + 64 * nc - 1) / (64 * nc);
  a.tiles_n = (N + kGeluQ8BN - 1) / kGeluQ8BN;
  a.stages = stages;
  CUtensorMap tx, tw;
  if (nc < 1 || nc > 3 ||
      !tensor_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, x8, K, M, ldx, kRowBytes, 64 * nc) ||
      !tensor_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w8, K, N, ldw, kRowBytes, kGeluQ8BN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nc) {
    case 1: return launch_gelu_q8<1>(tx, tw, a, clusters, smem, s);
    case 2: return launch_gelu_q8<2>(tx, tw, a, clusters, smem, s);
    default: return launch_gelu_q8<3>(tx, tw, a, clusters, smem, s);
  }
}

// How many clusters of cluster_ctas CTAs of the nc instantiation the card
// holds at once with smem bytes of dynamic shared memory each
// (cudaOccupancyMaxActiveClusters); a negative value is a CUDA error.  The
// host plan sizes the walk from it.
extern "C" int mm_linear_q8_gelu_q8_clusters(int nc, int cluster_ctas, int smem) {
  switch (nc) {
    case 1: return max_clusters_gelu_q8<1>(cluster_ctas, smem);
    case 2: return max_clusters_gelu_q8<2>(cluster_ctas, smem);
    case 3: return max_clusters_gelu_q8<3>(cluster_ctas, smem);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Once, when the library loads: the shared memory limit of every tile width
// and of each instantiation of the quantising GELU product (with its
// permission for 16-CTA clusters).
extern "C" int mm_linear_q8_init() {
  int e = mm::sm90::set_smem_limits<int>();
  if (e == 0) e = static_cast<int>(set_gelu_q8_attributes<1>());
  if (e == 0) e = static_cast<int>(set_gelu_q8_attributes<2>());
  if (e == 0) e = static_cast<int>(set_gelu_q8_attributes<3>());
  return e;
}
