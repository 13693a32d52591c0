// linear_q8: y = (x8 . w8^T) * s_row * s_col + b with int8 operands and an
// int32 sum, then one of three epilogues: bf16 out (Q/K/V), exact GELU kept
// in f32 (the FFN hidden, which the next quantisation reads in f32), or
// bf16 then "+ residual" in bf16 (output projections, FFN second product).
//
// Replaces _qdot8 / _qdot (mixermdm_tpu/ops/fused_block.py:66-77), the int8
// MXU products of the q8 Pallas block kernels (_sa_block_kernel_q8,
// _ca_block_kernel_q8, _ffn_kernel_q8).  The TPU kernels hold the whole int8
// E x E weight in VMEM; here it streams through shared memory.  At the
// denoiser shapes (M = rows * T ~ 2.4k, N, K = 1-3k) the work is bound by
// int8 tensor-core operations (1979 TOP/s dense on an H100 SXM), so the
// design is linear.cu's tiled GEMM, byte for byte: 128 x 128 block tiles
// with a 64-byte K slab (64 int8 here, 32 bf16 there), 8 warps of 64 x 32,
// cp.async double buffering, ldmatrix + mma.sync.m16n8k32.s8.  Both operands
// are K-contiguous (torch's (N, K) weight layout), mma's row.col form.  K must
// be a multiple of 16 (16-byte chunks all in or all out); the ragged M and N
// edges are masked.  wgmma.s8 / TMA are later work.
//
// The sum cannot overflow: |acc| <= 127^2 * K = 3.3e7 at K = 2048.  The
// dequantisation is the JAX package's, float(acc) * s_row * s_col + b in f32
// in that order, each step rounded on its own (__fmul_rn / __fadd_rn keep
// nvcc from contracting it into an FMA), so a bf16 output equals the plain
// version's bit for bit.
#include "common.cuh"

using mm::bf16;

namespace {

constexpr int BM = 128, BN = 128, BK = 64;  // BK in int8 elements (= bytes)
constexpr int LDS = BK + 16;  // shared row stride in bytes: 80, ldmatrix conflict-free
constexpr int kThreads = 256;

enum Epilogue { kBf16 = 0, kGeluF32 = 1, kResidual = 2 };

// Load a 128 x 64 int8 tile of a K-contiguous matrix (rows row0.., cols
// k0..) into shared memory, zero-filling rows >= rows_total and cols >= K.
__device__ __forceinline__ void load_tile(int8_t* s, const int8_t* g, long long ld,
                                          int rows_total, int row0, int k0, int K, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;  // 512 chunks of 16 bytes
    const int r = c >> 2;
    const int kc = (c & 3) * 16;
    const int gr = row0 + r, gk = k0 + kc;
    const bool ok = gr < rows_total && gk < K;  // K % 16 == 0: chunk all in or all out
    mm::cp_async16(s + r * LDS + kc, ok ? g + (size_t)gr * ld + gk : g, ok ? 16 : 0);
  }
}

template <int EPI>
__global__ void __launch_bounds__(kThreads)
    linear_q8_kernel(const int8_t* __restrict__ X, long long ldx, const float* __restrict__ SX,
                     const int8_t* __restrict__ W, long long ldw, const float* __restrict__ SW,
                     const bf16* __restrict__ bias, const bf16* __restrict__ R, long long ldr,
                     void* __restrict__ Y, long long ldy, int M, int N, int K) {
  __shared__ __align__(16) int8_t sA[2][BM * LDS];
  __shared__ __align__(16) int8_t sB[2][BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2;  // 2 warps along M, 64 rows each
  const int wn = warp & 3;   // 4 warps along N, 32 cols each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = (K + BK - 1) / BK;
  load_tile(sA[0], X, ldx, M, m0, 0, K, tid);
  load_tile(sB[0], W, ldw, N, n0, 0, K, tid);
  mm::cp_async_commit();

  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) {
      load_tile(sA[cur ^ 1], X, ldx, M, m0, (kt + 1) * BK, K, tid);
      load_tile(sB[cur ^ 1], W, ldw, N, n0, (kt + 1) * BK, K, tid);
    }
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();

    const int8_t* a = sA[cur];
    const int8_t* b = sB[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + (lane & 15);
        const int c = kk + (lane >> 4) * 16;
        mm::ldmatrix_x4(af[mi], a + r * LDS + c);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31)
        const int r = wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int c = kk + ((lane >> 3) & 1) * 16;
        uint32_t t[4];
        mm::ldmatrix_x4(t, b + r * LDS + c);
        bfr[2 * nj][0] = t[0];
        bfr[2 * nj][1] = t[1];
        bfr[2 * nj + 1][0] = t[2];
        bfr[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mm::mma_16832_s8(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mi * 16 + (lane >> 2) + h * 8;
        const int col = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
        if (row >= M) continue;
        const float sx = SX[row];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = col + e;
          if (cc >= N) continue;
          float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][h * 2 + e]), sx), SW[cc]);
          if (bias != nullptr) v = __fadd_rn(v, __bfloat162float(bias[cc]));
          const size_t o = (size_t)row * ldy + cc;
          if (EPI == kGeluF32) {
            static_cast<float*>(Y)[o] = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
          } else {
            bf16 out = __float2bfloat16(v);
            if (EPI == kResidual)
              out = __float2bfloat16(__bfloat162float(out) +
                                     __bfloat162float(R[(size_t)row * ldr + cc]));
            static_cast<bf16*>(Y)[o] = out;
          }
        }
      }
}

}  // namespace

// x8: (M, K) int8 row stride ldx, x_scale: (M,) f32; w8: (N, K) int8 row
// stride ldw, w_scale: (N,) f32; bias: (N,) bf16 or null; res: (M, N) bf16
// row stride ldr (epilogue 2 only); y: (M, N) row stride ldy, bf16
// (epilogues 0 and 2) or f32 (epilogue 1).  epilogue: 0 bf16, 1 exact GELU
// in f32, 2 bf16 + residual.  K % 16 == 0, ldx and ldw multiples of 16 and
// 16-byte aligned operands (checked by the Python wrapper).
extern "C" int mm_linear_q8(const void* x8, long long ldx, const void* x_scale, const void* w8,
                            long long ldw, const void* w_scale, const void* bias,
                            const void* res, long long ldr, void* y, long long ldy, int M, int N,
                            int K, int epilogue, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x8);
  const int8_t* wp = static_cast<const int8_t*>(w8);
  const float* sx = static_cast<const float*>(x_scale);
  const float* sw = static_cast<const float*>(w_scale);
  const bf16* bp = static_cast<const bf16*>(bias);
  const bf16* rp = static_cast<const bf16*>(res);
  switch (epilogue) {
    case kBf16:
      linear_q8_kernel<kBf16><<<grid, kThreads, 0, s>>>(xp, ldx, sx, wp, ldw, sw, bp, rp, ldr,
                                                        y, ldy, M, N, K);
      break;
    case kGeluF32:
      linear_q8_kernel<kGeluF32><<<grid, kThreads, 0, s>>>(xp, ldx, sx, wp, ldw, sw, bp, rp,
                                                           ldr, y, ldy, M, N, K);
      break;
    case kResidual:
      linear_q8_kernel<kResidual><<<grid, kThreads, 0, s>>>(xp, ldx, sx, wp, ldw, sw, bp, rp,
                                                            ldr, y, ldy, M, N, K);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
