// linear_epilogue: y = x @ W^T + b with an optional fused epilogue
// (exact GELU, or "+ residual" after rounding to bf16), bf16 in and out,
// f32 accumulation.
//
// Replaces the projection matmuls of the Pallas block kernels
// (mixermdm_tpu/ops/fused_block.py: the Q/K/V/O dots of _sa_block_kernel and
// _ca_block_kernel, the two dots and GELU of _ffn_kernel) and every other
// dense layer on the sampling path.  The TPU kernels keep all of E x E in
// VMEM; here weights stream through shared memory in 128 x 32 tiles.  At the
// denoiser shapes (M = rows * T ~ 2.4k, N, K = 1-3k) the work is bound by
// tensor-core operations, so the design is a classic tiled GEMM:
// 128 x 128 x 32 block tiles, 8 warps of 64 x 32, cp.async double buffering,
// ldmatrix + mma.sync.m16n8k16.  Both operands are K-contiguous (torch's
// Linear layout), which is exactly mma's row.col form.  The ragged M, N and K
// edges are masked; K % 8 != 0 (the 262-wide motion features) takes a
// scalar-load variant.  wgmma / TMA are later work.
#include "common.cuh"

using mm::bf16;

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDS = BK + 8;  // shared row stride in bf16: 80 B, ldmatrix conflict-free
constexpr int kThreads = 256;

enum Epilogue { kNone = 0, kGelu = 1, kResidual = 2 };

// Load a 128 x 32 tile of a K-contiguous matrix (rows row0.., cols k0..) into
// shared memory, zero-filling rows >= rows_total and cols >= K.
template <bool VEC>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long ld, int rows_total,
                                          int row0, int k0, int K, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;  // 512 chunks of 8 elements
    const int r = c >> 2;
    const int kc = (c & 3) * 8;
    const int gr = row0 + r, gk = k0 + kc;
    bf16* dst = s + r * LDS + kc;
    if (VEC) {
      const bool ok = gr < rows_total && gk < K;  // K % 8 == 0: chunk all in or all out
      mm::cp_async16(dst, ok ? g + (size_t)gr * ld + gk : g, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool ok = gr < rows_total && gk + j < K;
        dst[j] = ok ? g[(size_t)gr * ld + gk + j] : __float2bfloat16(0.f);
      }
    }
  }
}

template <int EPI, bool VEC>
__global__ void __launch_bounds__(kThreads)
    linear_kernel(const bf16* __restrict__ X, long long ldx, const bf16* __restrict__ W,
                  long long ldw, const bf16* __restrict__ bias, const bf16* __restrict__ R,
                  long long ldr, bf16* __restrict__ Y, long long ldy, int M, int N, int K) {
  __shared__ __align__(16) bf16 sA[2][BM * LDS];
  __shared__ __align__(16) bf16 sB[2][BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2;  // 2 warps along M, 64 rows each
  const int wn = warp & 3;   // 4 warps along N, 32 cols each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = (K + BK - 1) / BK;
  load_tile<VEC>(sA[0], X, ldx, M, m0, 0, K, tid);
  load_tile<VEC>(sB[0], W, ldw, N, n0, 0, K, tid);
  mm::cp_async_commit();

  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) {
      load_tile<VEC>(sA[cur ^ 1], X, ldx, M, m0, (kt + 1) * BK, K, tid);
      load_tile<VEC>(sB[cur ^ 1], W, ldw, N, n0, (kt + 1) * BK, K, tid);
    }
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();

    const bf16* a = sA[cur];
    const bf16* b = sB[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + (lane & 15);
        const int c = kk + (lane >> 4) * 8;
        mm::ldmatrix_x4(af[mi], a + r * LDS + c);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
        const int r = wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int c = kk + ((lane >> 3) & 1) * 8;
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
        for (int ni = 0; ni < 4; ++ni) mm::mma_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }

  // Epilogue: bias in f32, optional exact GELU, round to bf16, optional
  // residual add (the caller's bf16 "y + x", rounded again).
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mi * 16 + (lane >> 2) + h * 8;
        const int col = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
        if (row >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = col + e;
          if (cc >= N) continue;
          float v = acc[mi][ni][h * 2 + e];
          if (bias != nullptr) v += __bfloat162float(bias[cc]);
          if (EPI == kGelu) v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
          bf16 out = __float2bfloat16(v);
          if (EPI == kResidual)
            out = __float2bfloat16(__bfloat162float(out) +
                                   __bfloat162float(R[(size_t)row * ldr + cc]));
          Y[(size_t)row * ldy + cc] = out;
        }
      }
}

template <int EPI>
void launch(bool vec, dim3 grid, cudaStream_t s, const bf16* x, long long ldx, const bf16* w,
            long long ldw, const bf16* bias, const bf16* r, long long ldr, bf16* y,
            long long ldy, int M, int N, int K) {
  if (vec)
    linear_kernel<EPI, true><<<grid, kThreads, 0, s>>>(x, ldx, w, ldw, bias, r, ldr, y, ldy, M,
                                                       N, K);
  else
    linear_kernel<EPI, false><<<grid, kThreads, 0, s>>>(x, ldx, w, ldw, bias, r, ldr, y, ldy,
                                                        M, N, K);
}

}  // namespace

// x: (M, K) row stride ldx; w: (N, K) row stride ldw; bias: (N,) or null;
// res: (M, N) row stride ldr (epilogue 2 only); y: (M, N) row stride ldy.
// epilogue: 0 none, 1 exact GELU, 2 + residual.
extern "C" int mm_linear(const void* x, long long ldx, const void* w, long long ldw,
                         const void* bias, const void* res, long long ldr, void* y,
                         long long ldy, int M, int N, int K, int epilogue, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool vec = K % 8 == 0 && ldx % 8 == 0 && ldw % 8 == 0 && mm::aligned16(x) &&
                   mm::aligned16(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* bp = static_cast<const bf16*>(bias);
  const bf16* rp = static_cast<const bf16*>(res);
  bf16* yp = static_cast<bf16*>(y);
  switch (epilogue) {
    case kNone:
      launch<kNone>(vec, grid, s, xp, ldx, wp, ldw, bp, rp, ldr, yp, ldy, M, N, K);
      break;
    case kGelu:
      launch<kGelu>(vec, grid, s, xp, ldx, wp, ldw, bp, rp, ldr, yp, ldy, M, N, K);
      break;
    case kResidual:
      launch<kResidual>(vec, grid, s, xp, ldx, wp, ldw, bp, rp, ldr, yp, ldy, M, N, K);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
