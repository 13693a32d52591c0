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
//   the main path only K = 262 (motion_embed, rows of 524 or 1048 bytes, 4
//   launches per DDIM step).  cp.async copies as wide as the rows allow,
//   issued by every thread, into the wgmma layout of the TMA route, whose
//   plan and epilogue it shares (see "ragged route" below).
//
// Every route sums K in k16 steps from k = 0 up, each added to the f32 sums
// of the last.  No route splits K, so results are the same from run to run.
#include "gemm_sm90.cuh"

using mm::bf16;

namespace {

using mm::sm90::kGelu;
using mm::sm90::kPlain;
using mm::sm90::kResidual;

// Element-wise steps after the f32 sum of the skinny route (the TMA route
// has them in gemm_sm90.cuh, the ragged route in its staged epilogue): bias
// in f32, exact GELU, round to bf16, then the residual added in f32 and
// rounded again.
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

// Operands TMA cannot describe (rows whose stride or base is not 16-byte
// aligned): on the main path motion_embed, K = 262, whose x rows are 524
// bytes apart (a torch.cat of 262-wide rows) or 1048 (the view x[..., :262]
// of 524-wide rows) and whose W rows are 524 bytes apart.  At M = 2392 the
// product is 1.3 GFLOP on 6.7 MB (0.002 ms at 3.35 TB/s): what costs is
// latency and the issue of the copies.  The design:
// - every thread copies: the block's 8 warps share the cp.async copies of
//   each stage, at the widest granularity each operand's base and row
//   stride allow (16, 8 or 4 bytes: 4 for 524-byte rows, 8 for the
//   1048-byte view; rows only 2-byte aligned, at an odd K or stride, take
//   element loads), straight into the 128-byte-swizzled layout that TMA
//   writes and wgmma reads;
// - the whole ring is filled before the first product: 5-6 stages of 64 K
//   elements hold all of K = 262 at the plan's tile widths up to 192, so
//   every copy of a tile is in flight at once; a deeper K refills a slot
//   once its products are done;
// - K past its end is zero-filled (src-size < cp-size) up to the next k16
//   step and nothing past that is copied: the last stage runs only the k
//   steps that hold data.  Rows past M or N are not copied: they only feed
//   rows and columns of the tile that the epilogue does not store;
// - each 64-row half of the 128 x BN tile is one warpgroup's m64nBNk16
//   wgmma (gemm_sm90.cuh), after cp.async.wait_group, a proxy fence (wgmma
//   reads shared memory through the async proxy) and a block barrier;
// - the TMA route's tile plan (ops/linear.py: gemm_plan: 114 blocks at
//   N = 1024, 76 at 512 and 256 for M = 2392, one wave) and its staged
//   epilogue (coalesced 16-byte stores, the residual read the same way).
// The K sum runs in k16 steps from k = 0 up, as in every other route.
constexpr int kRaggedThreads = 256;  // two warpgroups, 64 rows of the tile each

template <int V>
__device__ __forceinline__ void cp_async_v(uint8_t* dst, const void* src, int src_bytes) {
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(mm::smem_u32(dst)),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(mm::smem_u32(dst)),
                 "l"(src), "n"(V), "r"(src_bytes));
}

// Rows row0 .. row0 + ROWS - 1 (those below rows_total) and K elements
// k0 .. k0 + 63 (those below kr, K rounded up to 16) of a K-contiguous bf16
// matrix with row stride ld elements, into a tile of 128-byte rows with the
// 128-byte swizzle, V bytes per copy.  Consecutive threads take consecutive
// pieces of a row, so a warp's copies are coalesced; each thread keeps one
// column piece and steps down the rows with one pointer.
template <int ROWS, int V>
__device__ __forceinline__ void copy_rows(uint8_t* dst, const bf16* g, long long ld,
                                          int rows_total, int row0, int k0, int K, int kr,
                                          int tid) {
  constexpr int kPerRow = 128 / V;
  constexpr int kStep = kRaggedThreads / kPerRow;  // rows per round
  const int r0 = tid / kPerRow, b = (tid % kPerRow) * V;
  const int k = k0 + b / 2;
  if (k >= kr) return;
  int n = 2 * (K - k);
  n = n < 0 ? 0 : (n > V ? V : n);  // bytes of this piece inside the row
  const int last = rows_total - row0 < ROWS ? rows_total - row0 : ROWS;
  const bf16* src = g + (size_t)(row0 + r0) * ld + k;
  for (int r = r0; r < last; r += kStep) {
    uint8_t* d = dst + r * 128 + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15));
    if constexpr (V == 2)
      *reinterpret_cast<bf16*>(d) = n > 0 ? *src : __float2bfloat16(0.f);
    else
      cp_async_v<V>(d, n > 0 ? src : g, n);
    src += kStep * ld;
  }
}

template <int ROWS>
__device__ __forceinline__ void copy_operand(uint8_t* dst, const bf16* g, long long ld, int v,
                                             int rows_total, int row0, int k0, int K, int kr,
                                             int tid) {
  switch (v) {
    case 16: copy_rows<ROWS, 16>(dst, g, ld, rows_total, row0, k0, K, kr, tid); break;
    case 8: copy_rows<ROWS, 8>(dst, g, ld, rows_total, row0, k0, K, kr, tid); break;
    case 4: copy_rows<ROWS, 4>(dst, g, ld, rows_total, row0, k0, K, kr, tid); break;
    default: copy_rows<ROWS, 2>(dst, g, ld, rows_total, row0, k0, K, kr, tid);
  }
}

struct RaggedOperands {
  const bf16* x;
  long long ldx;
  const bf16* w;
  long long ldw;
  int vx, vw;  // copy widths in bytes
};

template <int BN, bool kGelu>
__global__ void __launch_bounds__(kRaggedThreads, 1)
    linear_ragged_kernel(const RaggedOperands o, const mm::sm90::GemmArgs a) {
  using namespace mm::sm90;
  constexpr int kStage = stage_bytes(BN);
  extern __shared__ uint8_t rg_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(rg_raw) + kSmemAlign - 1) & ~uintptr_t(kSmemAlign - 1));
  const int S = a.stages;
  const int tid = threadIdx.x, cw = tid >> 7;
  uint8_t* stg = smem + S * kStage + cw * kEpiWgBytes;
  const int KT = (a.K + 63) / 64, kr = (a.K + 15) & ~15;
  const int tiles = a.tiles_m * a.tiles_n;

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % a.tiles_m) * BM, n0 = (t / a.tiles_m) * BN;
    auto load = [&](int kt) {
      uint8_t* st = smem + (kt % S) * kStage;
      copy_operand<BM>(st, o.x, o.ldx, o.vx, a.M, m0, kt * 64, a.K, kr, tid);
      copy_operand<BN>(st + BM * kRowBytes, o.w, o.ldw, o.vw, a.N, n0, kt * 64, a.K, kr, tid);
    };
    __syncthreads();  // the last tile's products are done with the ring
    // Every slot filled before the first product; one commit group per
    // stage, empty past K, so that group kt is stage kt.
    for (int s = 0; s < S; ++s) {
      if (s < KT) load(s);
      mm::cp_async_commit();
    }
    TileVectors<BN, false> tv;
    tv.load(a, m0 + cw * 64, n0, tid & 127);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      // This thread's copies of stage kt have landed (groups kt + 1 ..
      // kt + S - 1 may not): fence them to the async proxy, then wait for
      // every thread's.
      mm::cp_async_wait_dyn(S - 1);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const uint8_t* st = smem + (kt % S) * kStage;
      const uint64_t da = sw128_desc(st + cw * 64 * kRowBytes);
      const uint64_t db = sw128_desc(st + BM * kRowBytes);
      const int steps = (a.K - kt * 64 + 15) / 16;  // k16 steps of this stage with data
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < steps) mma<BN>(acc, da + 2 * k, db + 2 * k, (kt | k) != 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
      if (kt + S < KT) {  // refill this slot once both warpgroups are done with it
        __syncthreads();
        load(kt + S);
      }
      mm::cp_async_commit();
    }
    epilogue<BN, kGelu>(acc, a, m0 + cw * 64, n0, stg, tv, tid & 127, 1 + cw);
  }
}

template <int BN>
int launch_ragged(const RaggedOperands& o, const mm::sm90::GemmArgs& a, int grid, int smem,
                  cudaStream_t stream) {
  using namespace mm::sm90;
  if (a.stages < 2 || a.stages > 8 || smem < smem_bytes(BN, a.stages) || smem > kSmemLimit ||
      grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.epi == kGelu)
    linear_ragged_kernel<BN, true><<<grid, kRaggedThreads, smem, stream>>>(o, a);
  else
    linear_ragged_kernel<BN, false><<<grid, kRaggedThreads, smem, stream>>>(o, a);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
cudaError_t set_ragged_smem_limit() {
  using mm::sm90::kSmemLimit;
  cudaError_t e = cudaFuncSetAttribute(linear_ragged_kernel<BN, false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  return e != cudaSuccess ? e
                          : cudaFuncSetAttribute(linear_ragged_kernel<BN, true>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kSmemLimit);
}

// The widest copy (16, 8 or 4 bytes, else 2) to which every row start of a
// bf16 matrix at p with row stride ld elements is aligned: 4 for rows of
// 524 bytes, 8 for 1048, 2 for an odd row stride or a 2-byte base.
int copy_width(const void* p, long long ld) {
  for (int v = 16; v > 2; v /= 2)
    if (reinterpret_cast<uintptr_t>(p) % v == 0 && (ld * 2) % v == 0) return v;
  return 2;
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

// Ragged route: any shape, stride and alignment.  bn, stages, grid and smem
// from the host planner (ops/linear.py: gemm_plan, as for the TMA route); x
// and w are each copied as wide as their rows allow (copy_width).
extern "C" int mm_linear_ragged(const void* x, long long ldx, const void* w, long long ldw,
                                const void* bias, const void* res, long long ldr, void* y,
                                long long ldy, int M, int N, int K, int epilogue, int bn,
                                int stages, int grid, int smem, void* stream) {
  if (!valid_epilogue(epilogue) || M < 1 || N < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const RaggedOperands o{static_cast<const bf16*>(x), ldx, static_cast<const bf16*>(w), ldw,
                         copy_width(x, ldx), copy_width(w, ldw)};
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64: return launch_ragged<64>(o, a, grid, smem, s);
    case 128: return launch_ragged<128>(o, a, grid, smem, s);
    case 192: return launch_ragged<192>(o, a, grid, smem, s);
    case 256: return launch_ragged<256>(o, a, grid, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Once, when the library loads: the shared memory limits of the TMA route,
// of the skinny route's rings and of the ragged route's.
extern "C" int mm_linear_init() {
  cudaError_t e = cudaFuncSetAttribute(linear_skinny_kernel<1>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       skinny_smem_bytes(1));
  if (e == cudaSuccess) e = set_ragged_smem_limit<64>();
  if (e == cudaSuccess) e = set_ragged_smem_limit<128>();
  if (e == cudaSuccess) e = set_ragged_smem_limit<192>();
  if (e == cudaSuccess) e = set_ragged_smem_limit<256>();
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(linear_skinny_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             skinny_smem_bytes(2));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(linear_skinny_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             skinny_smem_bytes(4));
  return e != cudaSuccess ? static_cast<int>(e) : mm::sm90::set_smem_limits<float>();
}
