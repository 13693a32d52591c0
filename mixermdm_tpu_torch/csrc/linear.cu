// linear_epilogue: y = x @ W^T + b with an optional fused epilogue (exact
// GELU, or "+ residual" after rounding to bf16), bf16 in and out, f32 sums.
//
// Replaces the projection matmuls of the Pallas block kernels
// (mixermdm_tpu/ops/fused_block.py: the Q/K/V/O dots of _sa_block_kernel and
// _ca_block_kernel, the two dots and GELU of _ffn_kernel) and carries every
// other bf16 dense layer of the sampling path.  The TPU kernels keep all of
// E x E in VMEM; here the weights stream.  Three routes, chosen on the host
// by shape (ops/linear.py: gemm_plan), each counted under its own name:
//
// - linear_epilogue (mm_linear_tma): the block products, M = rows * T ~ 2.4k,
//   N and K 512-3072, bound by bf16 tensor-core operations (989 TFLOP/s).
//   The Hopper main loop of gemm_sm90.cuh: TMA, a 4-6 stage mbarrier ring,
//   m64nBNk16 wgmma in two consumer warpgroups, a persistent grid, and an
//   epilogue staged through shared memory into coalesced 16-byte stores.
//   Taken for every shape TMA can describe (16-byte aligned bases, row strides
//   a multiple of 16 bytes) with M > 64.
// - linear_epilogue_skinny (mm_linear_skinny): M <= 64, on the main path the
//   M = 8 layers (AdaLN modulations, time and text embeddings), bound by the
//   read of W (4.2 MB at K = 1024, N = 2048: 1.25 us at 3.35 TB/s).  A 128-row
//   tile would be 15/16 padding and cover 16 SMs, so a block is one warp on 8
//   columns of y (N / 8 blocks, 128-384 on the main path), and its lane 0
//   keeps a ring of TMA loads of W and x in flight (all of K = 1024 at once
//   for M <= 16); mma.sync.m16n8k16 with x as the 16-row operand, its rows
//   past M zero-filled by TMA.
// - linear_epilogue_ragged (mm_linear_ragged): what TMA cannot describe; on
//   the main path only K = 262 (motion_embed, rows of 524 bytes, 4 launches
//   per DDIM step).  A tiled mma.sync kernel with element-wise loads, 128 x
//   128 x 32 tiles: the port's first linear_epilogue, kept for this shape.
//
// Every route sums K in k16 steps from k = 0 up, each added to the f32 sums
// of the last.  No route splits K, so results are the same from run to run.
#include "gemm_sm90.cuh"

using mm::bf16;

namespace {

using mm::sm90::kGelu;
using mm::sm90::kPlain;
using mm::sm90::kResidual;

// Element-wise steps after the f32 sum, shared by the skinny and ragged
// routes (the TMA route has them in gemm_sm90.cuh): bias in f32, exact GELU,
// round to bf16, then the residual added in f32 and rounded again.
__device__ __forceinline__ bf16 finish(float v, const bf16* bias, int col, int epi,
                                       const bf16* res) {
  if (bias != nullptr) v += __bfloat162float(bias[col]);
  if (epi == kGelu) v = mm::sm90::gelu(v);
  bf16 out = __float2bfloat16(v);
  if (epi == kResidual) out = __float2bfloat16(__bfloat162float(out) + __bfloat162float(*res));
  return out;
}

// ---- skinny route -------------------------------------------------------------

constexpr int kSkinnyCols = 8;    // rows of W (columns of y) per block, one warp
constexpr int kSkinnyChunks = 4;  // 64-wide K chunks (128 bytes of a row) per stage
constexpr int kSkinnyStages = 4;  // all of K = 1024 in flight at once

__host__ __device__ constexpr int skinny_stage_bytes(int mt) {
  return kSkinnyChunks * (kSkinnyCols + 16 * mt) * 128;
}
__host__ __device__ constexpr int skinny_smem_bytes(int mt) {
  return mm::sm90::kSmemAlign + kSkinnyStages * (skinny_stage_bytes(mt) + 8);
}

// x: (M, K), M <= 16 * MT; w: (N, K); K a multiple of 64.  One warp per 8
// columns of y.  Both operands are read through 3-D tensor maps that see a
// row as K / 64 chunks of 128 bytes: one TMA box brings 4 chunks of the
// block's 8 rows of W (or of 16 * MT rows of x, rows >= M zero-filled), laid
// out chunk by chunk, 128-byte swizzled by row, so ldmatrix reads them
// without bank conflicts.  Lane 0 keeps a ring of such stages in flight (all
// of K = 1024 at once).  The products run in K order, one k16 step after the
// other into the same f32 sums from zero, as the TMA and ragged routes run
// them: a layer's output does not depend on which route its shape takes.
template <int MT>
__global__ void __launch_bounds__(32)
    linear_skinny_kernel(const __grid_constant__ CUtensorMap tma_x,
                         const __grid_constant__ CUtensorMap tma_w, const bf16* __restrict__ bias,
                         const bf16* __restrict__ R, long long ldr, bf16* __restrict__ Y,
                         long long ldy, int M, int N, int K, int epi) {
  constexpr int S = kSkinnyStages;
  constexpr int kStage = skinny_stage_bytes(MT);
  constexpr int kChunkW = kSkinnyCols * 128, kChunkX = 16 * MT * 128;
  extern __shared__ uint8_t sk_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(sk_raw) + mm::sm90::kSmemAlign - 1) &
      ~uintptr_t(mm::sm90::kSmemAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * kStage);
  const int lane = threadIdx.x;
  const int n0 = blockIdx.x * kSkinnyCols;
  const int chunks = K / 64;
  const int KT = (chunks + kSkinnyChunks - 1) / kSkinnyChunks;

  auto load = [&](int kt) {  // lane 0
    uint8_t* st = smem + (kt % S) * kStage;
    mm::sm90::mbar_expect_tx(&full[kt % S], kStage);
    mm::sm90::tma_load_3d(st, &tma_w, &full[kt % S], 0, n0, kt * kSkinnyChunks);
    mm::sm90::tma_load_3d(st + kSkinnyChunks * kChunkW, &tma_x, &full[kt % S], 0, 0,
                          kt * kSkinnyChunks);
  };
  if (lane == 0) {
    for (int s = 0; s < S; ++s) mm::sm90::mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kt = 0; kt < S && kt < KT; ++kt) load(kt);
  }
  __syncwarp();

  float acc[MT][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    mm::sm90::mbar_wait(&full[kt % S], (kt / S) & 1);
    const uint8_t* base = smem + (kt % S) * kStage;
#pragma unroll
    for (int c = 0; c < kSkinnyChunks; ++c) {
      // Chunk c's fragments first, so their loads overlap, then its four k16
      // products in order (chunks past K are zero: they add nothing).
      // B: W rows 0-7 at the 16-byte pieces 4p .. 4p + 3 (lanes 8j .. 8j + 7
      // give piece 4p + j): k steps 2p and 2p + 1 of the chunk.
      const uint8_t* wc = base + c * kChunkW;
      const uint8_t* xc = base + kSkinnyChunks * kChunkW + c * kChunkX;
      uint32_t b[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int r = lane & 7, q = 4 * p + (lane >> 3);
        uint32_t t4[4];
        mm::ldmatrix_x4(t4, wc + r * 128 + ((q ^ r) << 4));
        b[2 * p][0] = t4[0];
        b[2 * p][1] = t4[1];
        b[2 * p + 1][0] = t4[2];
        b[2 * p + 1][1] = t4[3];
      }
      // A: x rows 16t..16t+15 (lanes 0-15 and 16-31), pieces 2kk and 2kk + 1.
      uint32_t a[4][MT][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          const int r = 16 * t + (lane & 15), q = 2 * kk + (lane >> 4);
          mm::ldmatrix_x4(a[kk][t], xc + r * 128 + ((q ^ (r & 7)) << 4));
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int t = 0; t < MT; ++t) mm::mma_16816(acc[t], a[kk][t], b[kk]);
    }
    __syncwarp();  // every lane has read the stage: its slot takes stage kt + S
    if (lane == 0 && kt + S < KT) load(kt + S);
  }

  // acc[t]: rows 16t + g (e 0, 1) and 16t + g + 8 (e 2, 3), columns 2c, 2c + 1.
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * t + g + 8 * (e >> 1), col = n0 + 2 * c + (e & 1);
      if (row < M && col < N)
        Y[(size_t)row * ldy + col] = finish(acc[t][e], bias, col, epi,
                                            epi == kResidual ? R + (size_t)row * ldr + col : nullptr);
    }
}

// ---- ragged route -------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDS = BK + 8;  // shared row stride in bf16: 80 B, ldmatrix conflict-free
constexpr int kThreads = 256;

// Load a 128 x 32 tile of a K-contiguous matrix (rows row0.., cols k0..) into
// shared memory element by element, zero-filling rows >= rows_total and
// cols >= K (any K, any stride, any alignment).
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long ld, int rows_total,
                                          int row0, int k0, int K, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;  // 512 chunks of 8 elements
    const int r = c >> 2;
    const int kc = (c & 3) * 8;
    const int gr = row0 + r, gk = k0 + kc;
    bf16* dst = s + r * LDS + kc;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool ok = gr < rows_total && gk + j < K;
      dst[j] = ok ? g[(size_t)gr * ld + gk + j] : __float2bfloat16(0.f);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    linear_ragged_kernel(const bf16* __restrict__ X, long long ldx, const bf16* __restrict__ W,
                         long long ldw, const bf16* __restrict__ bias, const bf16* __restrict__ R,
                         long long ldr, bf16* __restrict__ Y, long long ldy, int M, int N, int K,
                         int epi) {
  __shared__ __align__(16) bf16 sA[BM * LDS];
  __shared__ __align__(16) bf16 sB[BN * LDS];

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

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile(sA, X, ldx, M, m0, k0, K, tid);
    load_tile(sB, W, ldw, N, n0, k0, K, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + (lane & 15);
        const int c = kk + (lane >> 4) * 8;
        mm::ldmatrix_x4(af[mi], sA + r * LDS + c);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
        const int r = wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int c = kk + ((lane >> 3) & 1) * 8;
        uint32_t t[4];
        mm::ldmatrix_x4(t, sB + r * LDS + c);
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
          Y[(size_t)row * ldy + cc] =
              finish(acc[mi][ni][h * 2 + e], bias, cc, epi,
                     epi == kResidual ? R + (size_t)row * ldr + cc : nullptr);
        }
      }
}

bool valid_epilogue(int epi) { return epi == kPlain || epi == kGelu || epi == kResidual; }

}  // namespace

// Every launcher: x (M, K) row stride ldx; w (N, K) row stride ldw; bias (N,)
// or null; res (M, N) row stride ldr (epilogue 2 only); y (M, N) row stride
// ldy.  epilogue: 0 none, 1 exact GELU, 2 + residual.  Returns the CUDA error
// of the launch (0 when it was accepted).

// TMA route.  x, w 16-byte aligned with row strides a multiple of 8 elements;
// bn, stages, grid and smem from the host planner (ops/linear.py: gemm_plan).
extern "C" int mm_linear_tma(const void* x, long long ldx, const void* w, long long ldw,
                             const void* bias, const void* res, long long ldr, void* y,
                             long long ldy, int M, int N, int K, int epilogue, int bn, int stages,
                             int grid, int smem, void* stream) {
  if (!valid_epilogue(epilogue)) return static_cast<int>(cudaErrorInvalidValue);
  mm::sm90::GemmArgs a{};
  a.bias = static_cast<const bf16*>(bias);
  a.res = static_cast<const bf16*>(res);
  a.ldr = ldr;
  a.y = y;
  a.ldy = ldy;
  a.M = M;
  a.N = N;
  a.K = K;
  a.epi = epilogue;
  a.vec_y = mm::sm90::rows_aligned16(y, ldy, 2);
  a.vec_r = epilogue == kResidual ? mm::sm90::rows_aligned16(res, ldr, 2) : 0;
  a.tiles_m = (M + mm::sm90::BM - 1) / mm::sm90::BM;
  a.tiles_n = (N + bn - 1) / bn;
  a.stages = stages;
  return mm::sm90::launch<float>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, ldx, w, ldw, a, bn, grid,
                                 smem, static_cast<cudaStream_t>(stream));
}

// Skinny route: M <= 64; K a multiple of 64; x, w 16-byte aligned with row
// strides a multiple of 8 elements (TMA describes them).
extern "C" int mm_linear_skinny(const void* x, long long ldx, const void* w, long long ldw,
                                const void* bias, const void* res, long long ldr, void* y,
                                long long ldy, int M, int N, int K, int epilogue, void* stream) {
  if (!valid_epilogue(epilogue) || M > 64 || K % 64) return static_cast<int>(cudaErrorInvalidValue);
  const int mt = M <= 16 ? 1 : M <= 32 ? 2 : 4;
  // (64 elements, rows, K / 64 chunks), chunks 128 bytes apart.
  const cuuint64_t xd[3] = {64, static_cast<cuuint64_t>(M), static_cast<cuuint64_t>(K / 64)};
  const cuuint64_t wd[3] = {64, static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K / 64)};
  const cuuint64_t xs[2] = {static_cast<cuuint64_t>(ldx) * 2, 128};
  const cuuint64_t ws[2] = {static_cast<cuuint64_t>(ldw) * 2, 128};
  const cuuint32_t xb[3] = {64, static_cast<cuuint32_t>(16 * mt), kSkinnyChunks};
  const cuuint32_t wb[3] = {64, kSkinnyCols, kSkinnyChunks};
  CUtensorMap tx, tw;
  if (!mm::sm90::tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 3, xd, xs, xb) ||
      !mm::sm90::tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, 3, wd, ws, wb))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kSkinnyCols - 1) / kSkinnyCols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* bp = static_cast<const bf16*>(bias);
  const bf16* rp = static_cast<const bf16*>(res);
  bf16* yp = static_cast<bf16*>(y);
  if (mt == 1)
    linear_skinny_kernel<1><<<grid, 32, skinny_smem_bytes(1), s>>>(tx, tw, bp, rp, ldr, yp, ldy,
                                                                   M, N, K, epilogue);
  else if (mt == 2)
    linear_skinny_kernel<2><<<grid, 32, skinny_smem_bytes(2), s>>>(tx, tw, bp, rp, ldr, yp, ldy,
                                                                   M, N, K, epilogue);
  else
    linear_skinny_kernel<4><<<grid, 32, skinny_smem_bytes(4), s>>>(tx, tw, bp, rp, ldr, yp, ldy,
                                                                   M, N, K, epilogue);
  return static_cast<int>(cudaGetLastError());
}

// Ragged route: any shape, stride and alignment.
extern "C" int mm_linear_ragged(const void* x, long long ldx, const void* w, long long ldw,
                                const void* bias, const void* res, long long ldr, void* y,
                                long long ldy, int M, int N, int K, int epilogue, void* stream) {
  if (!valid_epilogue(epilogue)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  linear_ragged_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), ldx, static_cast<const bf16*>(w), ldw,
      static_cast<const bf16*>(bias), static_cast<const bf16*>(res), ldr, static_cast<bf16*>(y),
      ldy, M, N, K, epilogue);
  return static_cast<int>(cudaGetLastError());
}

// Once, when the library loads: the shared memory limits of the TMA route
// and of the skinny route's rings.
extern "C" int mm_linear_init() {
  cudaError_t e = cudaFuncSetAttribute(linear_skinny_kernel<1>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       skinny_smem_bytes(1));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(linear_skinny_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             skinny_smem_bytes(2));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(linear_skinny_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             skinny_smem_bytes(4));
  return e != cudaSuccess ? static_cast<int>(e) : mm::sm90::set_smem_limits<float>();
}
