// attention_bwd: dq, dk, dv of softmax(Q K^T / sqrt(D) + key_bias) V with
// torch's add_zero_attn done algebraically, for bf16 or f32 inputs.
//
// Replaces mixermdm_tpu/ops/attention.py:_fused_attention_bwd_impl ->
// _attn_bwd_kernel (:323-439), the backward of the custom_vjp wrappers
// _fa_nomask / _fa_kpm.  It computes what the TPU kernel computes, with the
// same rounding points but one:
//   p    = exp(s - max) / den, f32, from the row max and denominator that the
//          forward wrote (csrc/attention.cu, ``stats``; the zero key is in
//          both, so this kernel needs no zero-attn flag);
//   dv   = round(p)^T g            (p rounded to the input dtype first);
//   dp   = g v^T;  dsum = rowsum(g * o)  (o the forward's output);
//   ds   = round(p * (dp - dsum));
//   dq   = ds k * scale;  dk = ds^T q * scale.
// Every product accumulates in f32 and dq / dk / dv are rounded to the input
// dtype once.  dsum is FlashAttention-2's identity rowsum(g * o) =
// rowsum(dp * p) (the zero key has v = 0: no term), where the TPU kernel
// sums dp * p: o reaches it rounded to the input dtype, which in bf16 moves
// the gradients by about what the bf16 rounding of ds already does
// (chip_smoke.py holds the kernel to the plain version of this form and
// reads its distance from the other), and it takes the pass over K and V
// that dsum cost and the order between the two kernels below.  The plain version
// (ops/attention.py:attention_bwd_plain, given ``out``) sums the same way.
//
// The TPU kernel holds the whole T x T panel of one head in VMEM; an H100
// block has 227 KB of shared memory and blocks run in no order, so the work
// is split the FlashAttention-2 way, with no atomics and a deterministic
// result:
//   dsum kernel  one warp per query row: rowsum(g * o);
//   main kernel  one launch, two kinds of block: one per (batch, head,
//                query tile), one pass over the key tiles, writes dq; one
//                per (batch, head, key tile), one pass over the query tiles,
//                writes dk and dv.
// At the training shapes the work is small and the kernels are latency
// bound; one launch of both kinds puts twice the warps on the SMs, and the
// per-element arithmetic is one exp2 and one multiply by the row's
// reciprocal denominator.
//
// bf16: 64-row tiles, 4 warps of 16 rows, every product an mma.sync
// m16n8k16 on the tensor cores with ldmatrix fragments (S = Q K^T and
// dP = G V^T from shared memory; P and dS packed from the accumulators into
// A fragments, V, K, Q, G read transposed for the second products), tiles
// double-buffered with 16-byte cp.async.  Bound at the discriminator shape
// (8, 4, 300, 64): bytes, 2.6 us.
//
// f32: every product on the tensor cores (mma.sync m16n8k8) in three TF32
// passes (csrc/tf32.cuh: x = hi + lo, both TF32; hi.hi + hi.lo + lo.hi, f32
// sums: ~2^-22 per product, within the 1e-5 the f32 path is held to).  On
// the CUDA cores each f32 FMA needed its own operand from shared memory,
// four times what the banks deliver per FMA slot.  Two kernels, picked by
// the host (ops/attention.py:attention_bwd_f32_plan):
// - attn_bwd_f32_kernel (the heads' training shapes, (8, 8, 77, 96)): the
//   same blocks as bf16, 64-row tiles streamed one at a time, P and dS
//   reaching their A fragments by warp shuffles, the streamed operand split
//   by every warp at every product.  At D 128 its 136 KB of shared memory
//   leave one 4-warp block to an SM.
// - attn_bwd_f32_tc_kernel (the InterCLIP towers' shapes): see its section.
#include <type_traits>

#include "common.cuh"
#include "tf32.cuh"

using mm::bf16;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;  // the reference's bias of a masked key

struct Params {
  const void *q, *k, *v, *g, *o;  // (B, H, T, D) contiguous, bf16 or f32
  void *dq, *dk, *dv;             // same layout and dtype
  const float* stats;             // (2, B, H, Tq): the forward's row max, denominator
  float* dsum;                    // (B, H, Tq): written by the dsum kernel
  const bool* kpm;                // (B, Tk), true = masked (bias -1e30), or null
  int B, H, Tq, Tk, zero_attn;
  float scale;
};

// The additive bias of key ``col`` of batch ``b``: -inf past Tk, -1e30 where
// masked (the load clamped to the row, so that it is not conditional).
__device__ __forceinline__ float key_bias(const Params& p, int b, int col) {
  const float v =
      p.kpm != nullptr && p.kpm[(size_t)b * p.Tk + min(col, p.Tk - 1)] ? kMasked : 0.f;
  return col < p.Tk ? v : -INFINITY;
}

// 2^x, one MUFU instruction (relative error ~2^-22; results below 2^-126
// flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p of one logit: the bias joins before the max is taken away, as in the
// reference (a -1e30 bias absorbs the logit, so a fully masked row without
// the zero key gets p = 1 / den; fmaf rounds as s * scale + kb does for kb
// in {0, -1e30, -inf}).  A key past Tk has kb = -inf, a query row past Tq
// inv_den = 0: p = 0 with no branch.
__device__ __forceinline__ float prob(float s, float scale, float kb, float mx, float inv_den) {
  return ex2((fmaf(s, scale, kb) - mx) * kLog2e) * inv_den;
}

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

// dsum = rowsum(g * o) in f32, one warp per row of the (B * H * Tq, D) rows.
template <typename T, int D>
__global__ void __launch_bounds__(256) attn_bwd_dsum_kernel(const Params p) {
  const size_t rows = (size_t)p.B * p.H * p.Tq;
  const size_t row = (size_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* g = static_cast<const T*>(p.g) + row * D;
  const T* o = static_cast<const T*>(p.o) + row * D;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < D / 32; ++j)
    acc = fmaf(to_f<T>(g[lane + 32 * j]), to_f<T>(o[lane + 32 * j]), acc);
  acc = mm::warp_sum(acc);
  if (lane == 0) p.dsum[row] = acc;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync
// ---------------------------------------------------------------------------

constexpr int BT = 64, kMmaThreads = 128;  // 64-row tiles; 4 warps x 16 rows

__host__ __device__ constexpr int mma_tile_elems(int d) { return BT * (d + 8); }
// Either kind of block: two resident tiles, two double-buffered, and the
// query tiles' statistics (3 x BT floats, double-buffered).
__host__ __device__ constexpr int mma_smem(int d) {
  return 6 * mma_tile_elems(d) * 2 + 2 * 3 * BT * 4;
}

// Rows row0.. of a (rows_total, D) matrix into shared rows of D + 8
// elements, zeros past the edge.
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* s, const bf16* g, int row0, int rows_total,
                                               int tid) {
  constexpr int LD = D + 8, CPR = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < BT * CPR; c += kMmaThreads) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    const bool ok = row0 + r < rows_total;
    mm::cp_async16(s + r * LD + cc, ok ? g + (size_t)(row0 + r) * D + cc : g, ok ? 16 : 0);
  }
}

// acc (this warp's 16 rows x 64 columns) = A[rows] . B[64 rows]^T over D; A
// and B are [row][d] in shared memory.  acc[t][e]: row lane/4 + 8 (e >> 1),
// column 8t + 2 (lane % 4) + (e & 1).
template <int D>
__device__ __forceinline__ void mma_nt(float (&acc)[8][4], const bf16* sA, const bf16* sB,
                                       int warp, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    mm::ldmatrix_x4(a, sA + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      uint32_t b[4];
      mm::ldmatrix_x4(b, sB + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                             ((lane >> 3) & 1) * 8);
      mm::mma_16816(acc[2 * nj], a, b);
      mm::mma_16816(acc[2 * nj + 1], a, b + 2);
    }
  }
}

// acc (16 rows x D) += A (16 x 64, bf16 A fragments over 64 k) . B (64 k x D,
// [k][d] in shared memory, read transposed).
template <int D>
__device__ __forceinline__ void mma_nn(float (&acc)[D / 8][4], const uint32_t (&a)[4][4],
                                       const bf16* sB, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t b[4];
      mm::ldmatrix_x4_trans(b, sB + (j * 16 + (lane & 15)) * LD + dt * 8 + ((lane >> 4) << 3));
      mm::mma_16816(acc[dt], a[j], b);
      mm::mma_16816(acc[dt + 1], a[j], b + 2);
    }
}

// Accumulator values (16 x 64) -> bf16 A fragments over the 64 columns: the
// rounding of p and ds to the input dtype.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&v)[8][4]) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    a[t >> 1][(t & 1) * 2 + 0] = mm::pack_bf16x2(v[t][0], v[t][1]);
    a[t >> 1][(t & 1) * 2 + 1] = mm::pack_bf16x2(v[t][2], v[t][3]);
  }
}

// A query-tile block: dq of rows q0.. over every key tile.
template <int D>
__device__ __forceinline__ void dq_mma(const Params& p, unsigned char* smem, int q0, int h,
                                       int b) {
  constexpr int NT = D / 8, TILE = mma_tile_elems(D);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + TILE;
  bf16* sKV = sG + TILE;  // buffer i: K at 2 i tiles, V after it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bh = (size_t)b * p.H + h, n = (size_t)p.B * p.H * p.Tq;
  const bf16* Q = static_cast<const bf16*>(p.q) + bh * p.Tq * D;
  const bf16* G = static_cast<const bf16*>(p.g) + bh * p.Tq * D;
  const bf16* K = static_cast<const bf16*>(p.k) + bh * p.Tk * D;
  const bf16* V = static_cast<const bf16*>(p.v) + bh * p.Tk * D;
  load_tile_bf16<D>(sQ, Q, q0, p.Tq, tid);
  load_tile_bf16<D>(sG, G, q0, p.Tq, tid);
  load_tile_bf16<D>(sKV, K, 0, p.Tk, tid);
  load_tile_bf16<D>(sKV + TILE, V, 0, p.Tk, tid);
  mm::cp_async_commit();

  const int r_lo = q0 + warp * 16 + (lane >> 2);  // rows r_lo and r_lo + 8
  float mx[2], inv[2], dsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    const bool ok = row < p.Tq;
    mx[i] = ok ? p.stats[bh * p.Tq + row] : 0.f;
    inv[i] = ok ? 1.f / p.stats[n + bh * p.Tq + row] : 0.f;
    dsum[i] = ok ? p.dsum[bh * p.Tq + row] : 0.f;
  }
  float dq[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[t][e] = 0.f;

  const int nkt = (p.Tk + BT - 1) / BT;
  for (int it = 0; it < nkt; ++it) {
    const int buf = it & 1, k0 = it * BT;
    if (it + 1 < nkt) {
      bf16* nb = sKV + 2 * (buf ^ 1) * TILE;
      load_tile_bf16<D>(nb, K, k0 + BT, p.Tk, tid);
      load_tile_bf16<D>(nb + TILE, V, k0 + BT, p.Tk, tid);
    }
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    const bf16* sK = sKV + 2 * buf * TILE;
    const bf16* sV = sK + TILE;

    float kb[16];  // keys k0 + 8t + 2(lane % 4) + c, c = 2t + (0, 1)
#pragma unroll
    for (int c = 0; c < 16; ++c)
      kb[c] = key_bias(p, b, k0 + (c >> 1) * 8 + (lane & 3) * 2 + (c & 1));
    float s[8][4], dp[8][4];
    mma_nt<D>(s, sQ, sK, warp, lane);
    mma_nt<D>(dp, sG, sV, warp, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float pv = prob(s[t][e], p.scale, kb[2 * t + (e & 1)], mx[i], inv[i]);
        s[t][e] = pv * (dp[t][e] - dsum[i]);
      }
    uint32_t ds[4][4];
    pack_a(ds, s);
    mma_nn<D>(dq, ds, sK, lane);
    __syncthreads();  // every warp is done with buf before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    if (row >= p.Tq) continue;
    bf16* dQ = static_cast<bf16*>(p.dq) + (bh * p.Tq + row) * D;
#pragma unroll
    for (int t = 0; t < NT; ++t)
      *reinterpret_cast<uint32_t*>(dQ + t * 8 + (lane & 3) * 2) =
          mm::pack_bf16x2(dq[t][2 * i] * p.scale, dq[t][2 * i + 1] * p.scale);
  }
}

// A key-tile block: dk and dv of keys k0.. over every query tile.
template <int D>
__device__ __forceinline__ void dkdv_mma(const Params& p, unsigned char* smem, int k0, int h,
                                         int b) {
  constexpr int NT = D / 8, TILE = mma_tile_elems(D);
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TILE;
  bf16* sQG = sV + TILE;                                // buffer i: Q at 2 i tiles, G after it
  float* sSt = reinterpret_cast<float*>(sQG + 4 * TILE);  // buffer i: max, den, dsum (3 x BT)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bh = (size_t)b * p.H + h, n = (size_t)p.B * p.H * p.Tq;
  const bf16* Q = static_cast<const bf16*>(p.q) + bh * p.Tq * D;
  const bf16* G = static_cast<const bf16*>(p.g) + bh * p.Tq * D;
  const bf16* K = static_cast<const bf16*>(p.k) + bh * p.Tk * D;
  const bf16* V = static_cast<const bf16*>(p.v) + bh * p.Tk * D;

  // The query tile's max, reciprocal denominator and dsum into buffer
  // ``buf`` (plain loads: visible after the next __syncthreads).
  auto load_stats = [&](int q0, int buf) {
    float* st = sSt + 3 * BT * buf;
    for (int i = tid; i < BT; i += kMmaThreads) {
      const int q = q0 + i;
      const bool ok = q < p.Tq;
      st[i] = ok ? p.stats[bh * p.Tq + q] : INFINITY;  // p = 0 past Tq
      st[BT + i] = ok ? 1.f / p.stats[n + bh * p.Tq + q] : 0.f;
      st[2 * BT + i] = ok ? p.dsum[bh * p.Tq + q] : 0.f;
    }
  };
  load_tile_bf16<D>(sK, K, k0, p.Tk, tid);
  load_tile_bf16<D>(sV, V, k0, p.Tk, tid);
  load_tile_bf16<D>(sQG, Q, 0, p.Tq, tid);
  load_tile_bf16<D>(sQG + TILE, G, 0, p.Tq, tid);
  mm::cp_async_commit();
  load_stats(0, 0);

  const int kr_lo = k0 + warp * 16 + (lane >> 2);  // keys kr_lo and kr_lo + 8
  const float kb[2] = {key_bias(p, b, kr_lo), key_bias(p, b, kr_lo + 8)};
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;

  const int nqt = (p.Tq + BT - 1) / BT;
  for (int it = 0; it < nqt; ++it) {
    const int buf = it & 1, q0 = it * BT;
    if (it + 1 < nqt) {
      bf16* nb = sQG + 2 * (buf ^ 1) * TILE;
      load_tile_bf16<D>(nb, Q, q0 + BT, p.Tq, tid);
      load_tile_bf16<D>(nb + TILE, G, q0 + BT, p.Tq, tid);
      load_stats(q0 + BT, buf ^ 1);
    }
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    const bf16* sQ = sQG + 2 * buf * TILE;
    const bf16* sG = sQ + TILE;
    const float* st = sSt + 3 * BT * buf;

    // S^T and dP^T: this warp's 16 keys x the tile's 64 queries.
    float s[8][4], dp[8][4];
    mma_nt<D>(s, sK, sQ, warp, lane);
    mma_nt<D>(dp, sV, sG, warp, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, qi = t * 8 + (lane & 3) * 2 + (e & 1);
        const float pv = prob(s[t][e], p.scale, kb[i], st[qi], st[BT + qi]);
        dp[t][e] = pv * (dp[t][e] - st[2 * BT + qi]);
        s[t][e] = pv;
      }
    uint32_t pa[4][4], dsa[4][4];
    pack_a(pa, s);
    pack_a(dsa, dp);
    mma_nn<D>(dv, pa, sG, lane);
    mma_nn<D>(dk, dsa, sQ, lane);
    __syncthreads();  // every warp is done with buf before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr_lo + 8 * i;
    if (key >= p.Tk) continue;
    bf16* dK = static_cast<bf16*>(p.dk) + (bh * p.Tk + key) * D;
    bf16* dV = static_cast<bf16*>(p.dv) + (bh * p.Tk + key) * D;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = t * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(dK + c) =
          mm::pack_bf16x2(dk[t][2 * i] * p.scale, dk[t][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dV + c) = mm::pack_bf16x2(dv[t][2 * i], dv[t][2 * i + 1]);
    }
  }
}

// Blocks 0 .. ceil(Tq / BT) - 1 along x take query tiles, the rest key tiles.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 3) attn_bwd_mma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nqt = (p.Tq + BT - 1) / BT;
  if (blockIdx.x < nqt)
    dq_mma<D>(p, smem_raw, blockIdx.x * BT, blockIdx.y, blockIdx.z);
  else
    dkdv_mma<D>(p, smem_raw, (blockIdx.x - nqt) * BT, blockIdx.y, blockIdx.z);
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 mma.sync
// ---------------------------------------------------------------------------

// The f32 tiles: 64 rows of D + 4 floats (rows 16 bytes apart in the banks,
// so the A and K-major B fragment reads are conflict-free).
__host__ __device__ constexpr int f32_tile_floats(int d) { return BT * (d + 4); }
// Either kind of block: two resident tiles, two streamed ones and the query
// tile's statistics (two blocks fit an SM at D <= 96).
__host__ __device__ constexpr int f32_smem(int d) { return (4 * f32_tile_floats(d) + 3 * BT) * 4; }

// Rows row0 .. row0 + rows - 1 of a contiguous (rows_total, D) matrix into
// shared rows of D + 4 floats, zeros past the edge.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* s, const float* g, int row0, int rows,
                                              int rows_total, int tid) {
  constexpr int LD = D + 4, CPR = D / 4;  // 16-byte chunks per row
  for (int c = tid; c < rows * CPR; c += kMmaThreads) {
    const int r = c / CPR, cc = (c % CPR) * 4;
    const bool ok = row0 + r < rows_total;
    mm::cp_async16(s + r * LD + cc, ok ? g + (size_t)(row0 + r) * D + cc : g, ok ? 16 : 0);
  }
}

using mm::mma3;
using mm::split_tf32;

// acc (this warp's 16 rows x 64 columns) = A[rows] . B[64 rows]^T over D;
// acc in the m16n8 accumulator layout.
template <int D>
__device__ __forceinline__ void tf32_nt(float (&acc)[8][4], const float* sA, const float* sB,
                                        int warp, int lane) {
  constexpr int LD = D + 4;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D / 8; ++kk) {
    const float* ap = sA + (warp * 16 + g) * LD + kk * 8 + t;
    uint32_t ah[4], al[4];
    split_tf32(ap[0], ah[0], al[0]);
    split_tf32(ap[8 * LD], ah[1], al[1]);
    split_tf32(ap[4], ah[2], al[2]);
    split_tf32(ap[8 * LD + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float* bp = sB + (n * 8 + g) * LD + kk * 8 + t;
      const float b[2] = {bp[0], bp[4]};
      mma3(acc[n], ah, al, b);
    }
  }
}

// acc (16 rows x D) += V (16 x 64, in the accumulator layout) . B (64 k x D,
// [k][d] in shared memory).  V's A fragments come from the accumulator by
// shuffles within each quad: A's column t of an 8-column block is held by
// lane t / 2 of the quad, as its element t % 2.
template <int D>
__device__ __forceinline__ void tf32_nn(float (&acc)[D / 8][4], const float (&v)[8][4],
                                        const float* sB, int lane) {
  constexpr int LD = D + 4;
  const int g = lane >> 2, t = lane & 3;
  const int src0 = (lane & ~3) | (t >> 1), src1 = src0 + 2;
  const bool odd = t & 1;
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    float a[4];
    {
      const float x0 = __shfl_sync(0xffffffffu, v[kb][0], src0);
      const float x1 = __shfl_sync(0xffffffffu, v[kb][1], src0);
      const float y0 = __shfl_sync(0xffffffffu, v[kb][2], src0);
      const float y1 = __shfl_sync(0xffffffffu, v[kb][3], src0);
      const float z0 = __shfl_sync(0xffffffffu, v[kb][0], src1);
      const float z1 = __shfl_sync(0xffffffffu, v[kb][1], src1);
      const float w0 = __shfl_sync(0xffffffffu, v[kb][2], src1);
      const float w1 = __shfl_sync(0xffffffffu, v[kb][3], src1);
      a[0] = odd ? x1 : x0;  // (g, t)
      a[1] = odd ? y1 : y0;  // (g + 8, t)
      a[2] = odd ? z1 : z0;  // (g, t + 4)
      a[3] = odd ? w1 : w0;  // (g + 8, t + 4)
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float* bp = sB + (kb * 8 + t) * LD + n * 8 + g;
      const float b[2] = {bp[0], bp[4 * LD]};
      mma3(acc[n], ah, al, b);
    }
  }
}

// A query-tile block: dq of rows q0.. over every key tile.
template <int D>
__device__ __forceinline__ void dq_f32(const Params& p, unsigned char* smem, int q0, int h,
                                       int b) {
  constexpr int NT = D / 8, TILE = f32_tile_floats(D);
  float* sQ = reinterpret_cast<float*>(smem);
  float* sG = sQ + TILE;
  float* sK = sG + TILE;
  float* sV = sK + TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const size_t bh = (size_t)b * p.H + h, n = (size_t)p.B * p.H * p.Tq;
  const float* Q = static_cast<const float*>(p.q) + bh * p.Tq * D;
  const float* G = static_cast<const float*>(p.g) + bh * p.Tq * D;
  const float* K = static_cast<const float*>(p.k) + bh * p.Tk * D;
  const float* V = static_cast<const float*>(p.v) + bh * p.Tk * D;
  load_rows_f32<D>(sQ, Q, q0, BT, p.Tq, tid);
  load_rows_f32<D>(sG, G, q0, BT, p.Tq, tid);

  const int r_lo = q0 + warp * 16 + (lane >> 2);  // rows r_lo and r_lo + 8
  float mx[2], inv[2], dsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    const bool ok = row < p.Tq;
    mx[i] = ok ? p.stats[bh * p.Tq + row] : 0.f;
    inv[i] = ok ? 1.f / p.stats[n + bh * p.Tq + row] : 0.f;
    dsum[i] = ok ? p.dsum[bh * p.Tq + row] : 0.f;
  }
  float dq[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[t][e] = 0.f;

  for (int k0 = 0; k0 < p.Tk; k0 += BT) {
    __syncthreads();  // every warp is done with the previous K, V tile
    load_rows_f32<D>(sK, K, k0, BT, p.Tk, tid);
    load_rows_f32<D>(sV, V, k0, BT, p.Tk, tid);
    mm::cp_async_commit();
    float kb[16];  // keys k0 + 8t + 2(lane % 4) + c, c = 2t + (0, 1)
#pragma unroll
    for (int c = 0; c < 16; ++c)
      kb[c] = key_bias(p, b, k0 + (c >> 1) * 8 + (lane & 3) * 2 + (c & 1));
    mm::cp_async_wait<0>();
    __syncthreads();
    float s[8][4], dp[8][4];
    tf32_nt<D>(s, sQ, sK, warp, lane);
    tf32_nt<D>(dp, sG, sV, warp, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        s[t][e] = prob(s[t][e], p.scale, kb[2 * t + (e & 1)], mx[i], inv[i]) *
                  (dp[t][e] - dsum[i]);
      }
    tf32_nn<D>(dq, s, sK, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    if (row >= p.Tq) continue;
    float* dQ = static_cast<float*>(p.dq) + (bh * p.Tq + row) * D;
#pragma unroll
    for (int t = 0; t < NT; ++t)
      *reinterpret_cast<float2*>(dQ + t * 8 + (lane & 3) * 2) =
          make_float2(dq[t][2 * i] * p.scale, dq[t][2 * i + 1] * p.scale);
  }
}

// A key-tile block: dk and dv of keys k0.. over every query tile.
template <int D>
__device__ __forceinline__ void dkdv_f32(const Params& p, unsigned char* smem, int k0, int h,
                                         int b) {
  constexpr int NT = D / 8, TILE = f32_tile_floats(D);
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + TILE;
  float* sQ = sV + TILE;
  float* sG = sQ + TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* st = sG + TILE;  // max, 1 / den, dsum (3 x BT)

  const size_t bh = (size_t)b * p.H + h, n = (size_t)p.B * p.H * p.Tq;
  const float* Q = static_cast<const float*>(p.q) + bh * p.Tq * D;
  const float* G = static_cast<const float*>(p.g) + bh * p.Tq * D;
  const float* K = static_cast<const float*>(p.k) + bh * p.Tk * D;
  const float* V = static_cast<const float*>(p.v) + bh * p.Tk * D;
  load_rows_f32<D>(sK, K, k0, BT, p.Tk, tid);
  load_rows_f32<D>(sV, V, k0, BT, p.Tk, tid);

  const int kr_lo = k0 + warp * 16 + (lane >> 2);  // keys kr_lo and kr_lo + 8
  const float kb[2] = {key_bias(p, b, kr_lo), key_bias(p, b, kr_lo + 8)};
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;

  for (int q0 = 0; q0 < p.Tq; q0 += BT) {
    __syncthreads();  // every warp is done with the previous Q, G tile
    load_rows_f32<D>(sQ, Q, q0, BT, p.Tq, tid);
    load_rows_f32<D>(sG, G, q0, BT, p.Tq, tid);
    mm::cp_async_commit();
    for (int i = tid; i < BT; i += kMmaThreads) {
      const int q = q0 + i;
      const bool ok = q < p.Tq;
      st[i] = ok ? p.stats[bh * p.Tq + q] : INFINITY;  // p = 0 past Tq
      st[BT + i] = ok ? 1.f / p.stats[n + bh * p.Tq + q] : 0.f;
      st[2 * BT + i] = ok ? p.dsum[bh * p.Tq + q] : 0.f;
    }
    mm::cp_async_wait<0>();
    __syncthreads();
    // S^T and dP^T: this warp's 16 keys x the tile's 64 queries.
    float s[8][4], dp[8][4];
    tf32_nt<D>(s, sK, sQ, warp, lane);
    tf32_nt<D>(dp, sV, sG, warp, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, qi = t * 8 + (lane & 3) * 2 + (e & 1);
        const float pv = prob(s[t][e], p.scale, kb[i], st[qi], st[BT + qi]);
        dp[t][e] = pv * (dp[t][e] - st[2 * BT + qi]);
        s[t][e] = pv;
      }
    tf32_nn<D>(dv, s, sG, lane);
    tf32_nn<D>(dk, dp, sQ, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr_lo + 8 * i;
    if (key >= p.Tk) continue;
    float* dK = static_cast<float*>(p.dk) + (bh * p.Tk + key) * D;
    float* dV = static_cast<float*>(p.dv) + (bh * p.Tk + key) * D;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = t * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(dK + c) =
          make_float2(dk[t][2 * i] * p.scale, dk[t][2 * i + 1] * p.scale);
      *reinterpret_cast<float2*>(dV + c) = make_float2(dv[t][2 * i], dv[t][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2) attn_bwd_f32_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nqt = (p.Tq + BT - 1) / BT;
  if (blockIdx.x < nqt)
    dq_f32<D>(p, smem_raw, blockIdx.x * BT, blockIdx.y, blockIdx.z);
  else
    dkdv_f32<D>(p, smem_raw, (blockIdx.x - nqt) * BT, blockIdx.y, blockIdx.z);
}

// ---------------------------------------------------------------------------
// f32, tiled for the long rows (attn_bwd_f32_tc_kernel): the same two kinds
// of block, each with its own 64-row tiles (Q and G, or K and V) resident,
// while the other side streams through a ring of two sub-tiles of R rows
// (16 up to D = 96, 8 at D = 128) filled by 16-byte cp.async, the next one
// in flight while the current one is multiplied.  Each sub-tile, once
// landed, is split in place into its TF32 hi parts (the lo parts beside it)
// by the whole block, once.  P and dS reach their A fragments in registers
// (csrc/tf32.cuh: the accumulator's columns taken as 2t -> t, 2t + 1 ->
// t + 4, the B rows read to match).  At D = 128 a block's shared memory is
// 93 KB, so two blocks (8 warps) share an SM, and a key-tile block holds
// dk and dv (128 floats a thread) beside a sub-tile's S and dP (8).
//
// Keys all masked: skipped under the forward's rule (attention.cu), where
// the row max is finite (the zero key is on, or the batch has an unmasked
// key), so p = exp(-1e30 - max) = 0 there exactly: a key-tile block whose
// 64 keys are all masked writes zero dk and dv and returns (p = 0 gives
// ds = 0), and a query-tile block passes over such sub-tiles of keys.
// ---------------------------------------------------------------------------

// Streamed rows per sub-tile.
__host__ __device__ constexpr int tc_rows(int d) { return d <= 96 ? 16 : 8; }
// Either kind of block: two resident tiles, the hi ring (two tensors of a
// sub-tile per stage), the current sub-tile's lo parts, and (key-tile
// blocks) each stage's query statistics.  ops/attention.py:attention_bwd_tc_smem
// is the same formula.
__host__ __device__ constexpr int tc_smem(int d) {
  return ((2 * BT + 6 * tc_rows(d)) * (d + 4) + 6 * tc_rows(d)) * 4;
}

// acc[n] (this warp's 16 resident rows x the sub-tile's R streamed rows) =
// A[rows] . B[R rows]^T over D, for two products at once: (A0, B0) into
// acc0, (A1, B1) into acc1.  A raw (split here, once per k-step for both
// n-tiles), B split (hi, lo), read just before its products (at D = 128
// the key-tile block holds dk and dv beside these: 254 registers).
template <int D, int R>
__device__ __forceinline__ void tc_nt2(float (&acc0)[R / 8][4], float (&acc1)[R / 8][4],
                                       const float* a0, const float* a1, const float* b0h,
                                       const float* b0l, const float* b1h, const float* b1l,
                                       int g, int t) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int n = 0; n < R / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[n][e] = acc1[n][e] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D / 8; ++kk) {
    const int ao = g * LD + kk * 8 + t;
    const float x0[4] = {a0[ao], a0[ao + 8 * LD], a0[ao + 4], a0[ao + 8 * LD + 4]};
    const float x1[4] = {a1[ao], a1[ao + 8 * LD], a1[ao + 4], a1[ao + 8 * LD + 4]};
    uint32_t h0[4], l0[4], h1[4], l1[4];
    mm::split_a(x0, h0, l0);
    mm::split_a(x1, h1, l1);
#pragma unroll
    for (int n = 0; n < R / 8; ++n) {
      const int off = (n * 8 + g) * LD + kk * 8 + t;
      const uint32_t bh0[2] = {__float_as_uint(b0h[off]), __float_as_uint(b0h[off + 4])};
      const uint32_t bl0[2] = {__float_as_uint(b0l[off]), __float_as_uint(b0l[off + 4])};
      mm::mma3_split(acc0[n], h0, l0, bh0, bl0);
      const uint32_t bh1[2] = {__float_as_uint(b1h[off]), __float_as_uint(b1h[off + 4])};
      const uint32_t bl1[2] = {__float_as_uint(b1l[off]), __float_as_uint(b1l[off + 4])};
      mm::mma3_split(acc1[n], h1, l1, bh1, bl1);
    }
  }
}

// acc (16 x D) += V (16 x R, an accumulator) . B (R x D split, [k][d]):
// k-step kb is V's n-tile kb, its B rows 8 kb + 2t and 8 kb + 2t + 1.
template <int D, int R>
__device__ __forceinline__ void tc_nn(float (&acc)[D / 8][4], const float (&v)[R / 8][4],
                                      const float* bh, const float* bl, int g, int t) {
#pragma unroll
  for (int kb = 0; kb < R / 8; ++kb)
    mm::mma3_acc_nn<D / 8, D + 4>(acc, v[kb], bh, bl, kb * 8, g, t);
}

// Whether this batch's fully masked keys may be passed over (see above).
__device__ __forceinline__ bool may_skip(const Params& p, const bool* kpm_b, int lane) {
  return kpm_b != nullptr && (p.zero_attn || mm::keys_live(kpm_b, 0, p.Tk, p.Tk, lane));
}

// A query-tile block: dq of rows q0.. over the key sub-tiles.
template <int D>
__device__ __forceinline__ void dq_tc(const Params& p, float* smem, int q0, int h, int b) {
  constexpr int LD = D + 4, NT = D / 8, R = tc_rows(D), ST = R * LD;
  float* sQ = smem;
  float* sG = sQ + BT * LD;
  float* sHi = sG + BT * LD;  // stage s: K at sub-tile 2 s, V at 2 s + 1
  float* sLo = sHi + 4 * ST;  // the current sub-tile's K, then V
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  const size_t bh = (size_t)b * p.H + h, n_all = (size_t)p.B * p.H * p.Tq;
  const float* Q = static_cast<const float*>(p.q) + bh * p.Tq * D;
  const float* G = static_cast<const float*>(p.g) + bh * p.Tq * D;
  const float* K = static_cast<const float*>(p.k) + bh * p.Tk * D;
  const float* V = static_cast<const float*>(p.v) + bh * p.Tk * D;
  const bool* kpm_b = p.kpm != nullptr ? p.kpm + (size_t)b * p.Tk : nullptr;
  const bool skip = may_skip(p, kpm_b, lane);
  const int nst = (p.Tk + R - 1) / R;
  auto next = [&](int j) {
    if (skip)
      while (j < nst && !mm::keys_live(kpm_b, j * R, R, p.Tk, lane)) ++j;
    return j;
  };
  auto issue = [&](int j, int st) {
    load_rows_f32<D>(sHi + 2 * st * ST, K, j * R, R, p.Tk, tid);
    load_rows_f32<D>(sHi + (2 * st + 1) * ST, V, j * R, R, p.Tk, tid);
  };
  load_rows_f32<D>(sQ, Q, q0, BT, p.Tq, tid);
  load_rows_f32<D>(sG, G, q0, BT, p.Tq, tid);
  int j = next(0);
  if (j < nst) issue(j, 0);
  mm::cp_async_commit();

  const int r_lo = q0 + warp * 16 + g;  // rows r_lo and r_lo + 8
  float mx[2], inv[2], dsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    const bool ok = row < p.Tq;
    mx[i] = ok ? p.stats[bh * p.Tq + row] : 0.f;
    inv[i] = ok ? 1.f / p.stats[n_all + bh * p.Tq + row] : 0.f;
    dsum[i] = ok ? p.dsum[bh * p.Tq + row] : 0.f;
  }
  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const float* qw = sQ + warp * 16 * LD;
  const float* gw = sG + warp * 16 * LD;

  for (int st = 0; j < nst; st ^= 1) {
    mm::cp_async_wait<0>();
    __syncthreads();  // sub-tile j has landed; every warp is done with the previous one
    const int jn = next(j + 1);
    if (jn < nst) issue(jn, st ^ 1);
    mm::cp_async_commit();
    const float* kh = sHi + 2 * st * ST;
    const float* vh = kh + ST;
    mm::split_inplace(sHi + 2 * st * ST, sLo, 2 * ST / 4, tid, kMmaThreads);
    __syncthreads();
    float s[R / 8][4], dp[R / 8][4];
    tc_nt2<D, R>(s, dp, qw, gw, kh, sLo, vh, sLo + ST, g, t);
    const int k0 = j * R;
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float kb = key_bias(p, b, k0 + n * 8 + 2 * t + (e & 1));
        s[n][e] = prob(s[n][e], p.scale, kb, mx[i], inv[i]) * (dp[n][e] - dsum[i]);
      }
    tc_nn<D, R>(dq, s, kh, sLo, g, t);
    j = jn;
  }
  mm::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    if (row >= p.Tq) continue;
    float* dQ = static_cast<float*>(p.dq) + (bh * p.Tq + row) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(dQ + n * 8 + 2 * t) =
          make_float2(dq[n][2 * i] * p.scale, dq[n][2 * i + 1] * p.scale);
  }
}

// A key-tile block: dk and dv of keys k0.. over the query sub-tiles.
template <int D>
__device__ __forceinline__ void dkdv_tc(const Params& p, float* smem, int k0, int h, int b) {
  constexpr int LD = D + 4, NT = D / 8, R = tc_rows(D), ST = R * LD;
  float* sK = smem;
  float* sV = sK + BT * LD;
  float* sHi = sV + BT * LD;  // stage s: Q at sub-tile 2 s, G at 2 s + 1
  float* sLo = sHi + 4 * ST;  // the current sub-tile's Q, then G
  float* sSt = sLo + 2 * ST;  // stage s: max, 1 / den, dsum (3 x R)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  const size_t bh = (size_t)b * p.H + h, n_all = (size_t)p.B * p.H * p.Tq;
  const bool* kpm_b = p.kpm != nullptr ? p.kpm + (size_t)b * p.Tk : nullptr;
  const int kr_lo = k0 + warp * 16 + g;  // keys kr_lo and kr_lo + 8
  if (may_skip(p, kpm_b, lane) && !mm::keys_live(kpm_b, k0, BT, p.Tk, lane)) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = kr_lo + 8 * i;
      if (key >= p.Tk) continue;
      float* dK = static_cast<float*>(p.dk) + (bh * p.Tk + key) * D;
      float* dV = static_cast<float*>(p.dv) + (bh * p.Tk + key) * D;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        *reinterpret_cast<float2*>(dK + n * 8 + 2 * t) = make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(dV + n * 8 + 2 * t) = make_float2(0.f, 0.f);
      }
    }
    return;
  }
  const float* Q = static_cast<const float*>(p.q) + bh * p.Tq * D;
  const float* G = static_cast<const float*>(p.g) + bh * p.Tq * D;
  const float* K = static_cast<const float*>(p.k) + bh * p.Tk * D;
  const float* V = static_cast<const float*>(p.v) + bh * p.Tk * D;
  auto issue = [&](int j, int st) {
    load_rows_f32<D>(sHi + 2 * st * ST, Q, j * R, R, p.Tq, tid);
    load_rows_f32<D>(sHi + (2 * st + 1) * ST, G, j * R, R, p.Tq, tid);
    float* sst = sSt + 3 * R * st;  // plain stores: read after the next barrier but one
    for (int i = tid; i < R; i += kMmaThreads) {
      const int q = j * R + i;
      const bool ok = q < p.Tq;
      sst[i] = ok ? p.stats[bh * p.Tq + q] : INFINITY;  // p = 0 past Tq
      sst[R + i] = ok ? 1.f / p.stats[n_all + bh * p.Tq + q] : 0.f;
      sst[2 * R + i] = ok ? p.dsum[bh * p.Tq + q] : 0.f;
    }
  };
  load_rows_f32<D>(sK, K, k0, BT, p.Tk, tid);
  load_rows_f32<D>(sV, V, k0, BT, p.Tk, tid);
  issue(0, 0);
  mm::cp_async_commit();

  const float kb[2] = {key_bias(p, b, kr_lo), key_bias(p, b, kr_lo + 8)};
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float* kw = sK + warp * 16 * LD;
  const float* vw = sV + warp * 16 * LD;

  const int nst = (p.Tq + R - 1) / R;
  for (int j = 0, st = 0; j < nst; ++j, st ^= 1) {
    mm::cp_async_wait<0>();
    __syncthreads();  // sub-tile j has landed; every warp is done with the previous one
    if (j + 1 < nst) issue(j + 1, st ^ 1);
    mm::cp_async_commit();
    const float* qh = sHi + 2 * st * ST;
    const float* gh = qh + ST;
    const float* sst = sSt + 3 * R * st;
    mm::split_inplace(sHi + 2 * st * ST, sLo, 2 * ST / 4, tid, kMmaThreads);
    __syncthreads();
    // S^T and dP^T: this warp's 16 keys x the sub-tile's R queries.
    float s[R / 8][4], dp[R / 8][4];
    tc_nt2<D, R>(s, dp, kw, vw, qh, sLo, gh, sLo + ST, g, t);
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, qi = n * 8 + 2 * t + (e & 1);
        const float pv = prob(s[n][e], p.scale, kb[i], sst[qi], sst[R + qi]);
        dp[n][e] = pv * (dp[n][e] - sst[2 * R + qi]);
        s[n][e] = pv;
      }
    tc_nn<D, R>(dv, s, gh, sLo + ST, g, t);
    tc_nn<D, R>(dk, dp, qh, sLo, g, t);
  }
  mm::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr_lo + 8 * i;
    if (key >= p.Tk) continue;
    float* dK = static_cast<float*>(p.dk) + (bh * p.Tk + key) * D;
    float* dV = static_cast<float*>(p.dv) + (bh * p.Tk + key) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      *reinterpret_cast<float2*>(dK + c) =
          make_float2(dk[n][2 * i] * p.scale, dk[n][2 * i + 1] * p.scale);
      *reinterpret_cast<float2*>(dV + c) = make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2) attn_bwd_f32_tc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int nqt = (p.Tq + BT - 1) / BT;
  if (blockIdx.x < nqt)
    dq_tc<D>(p, smem, blockIdx.x * BT, blockIdx.y, blockIdx.z);
  else
    dkdv_tc<D>(p, smem, (blockIdx.x - nqt) * BT, blockIdx.y, blockIdx.z);
}

// ---------------------------------------------------------------------------

// The dsum kernel, then the main kernel: blocks of query tiles and of key
// tiles side by side along x.
template <typename T, int D>
int launch(const Params& p, int route, cudaStream_t s) {
  constexpr bool f32 = std::is_same<T, float>::value;
  const size_t rows = (size_t)p.B * p.H * p.Tq;
  attn_bwd_dsum_kernel<T, D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.Tq + BT - 1) / BT + (p.Tk + BT - 1) / BT, p.H, p.B);
  if (f32 && route == 1)
    attn_bwd_f32_tc_kernel<D><<<grid, kMmaThreads, tc_smem(D), s>>>(p);
  else if (f32)
    attn_bwd_f32_kernel<D><<<grid, kMmaThreads, f32_smem(D), s>>>(p);
  else
    attn_bwd_mma_kernel<D><<<grid, kMmaThreads, mma_smem(D), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
cudaError_t set_smem() {
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_mma_kernel<D>, a, mma_smem(D));
  if (e == cudaSuccess) e = cudaFuncSetAttribute(attn_bwd_f32_kernel<D>, a, f32_smem(D));
  return e != cudaSuccess ? e : cudaFuncSetAttribute(attn_bwd_f32_tc_kernel<D>, a, tc_smem(D));
}

}  // namespace

// q, g, o, dq: (B, H, Tq, D); k, v, dk, dv: (B, H, Tk, D); all contiguous,
// bf16, or f32 when in_f32; o is the forward's output.  stats: (2, B, H, Tq)
// f32, the forward's row max and denominator (mm_attention's stats).  dsum:
// (B, H, Tq) f32 scratch.  kpm (B, Tk) bool, true = masked, or null.  D in {64, 96, 128}.
// zero_attn: whether the forward had the zero key (only the f32 tiled
// route reads it, to skip fully masked keys).  route (f32 only, the host's
// plan): 0 the kernel of 64-row tiles streamed one at a time, 1 the tiled
// one with split sub-tiles.  Two launches on the stream, in order.
extern "C" int mm_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                const void* o, void* dq, void* dk, void* dv, const void* stats,
                                void* dsum, const void* kpm, int B, int H, int Tq, int Tk,
                                int D, float scale, int in_f32, int zero_attn, int route,
                                void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.o = o;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.stats = static_cast<const float*>(stats);
  p.dsum = static_cast<float*>(dsum);
  p.kpm = static_cast<const bool*>(kpm);
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.scale = scale;
  p.zero_attn = zero_attn;
  if (route != 0 && (route != 1 || !in_f32)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return in_f32 ? launch<float, 64>(p, route, s) : launch<bf16, 64>(p, route, s);
    case 96: return in_f32 ? launch<float, 96>(p, route, s) : launch<bf16, 96>(p, route, s);
    case 128: return in_f32 ? launch<float, 128>(p, route, s) : launch<bf16, 128>(p, route, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Once, when the library loads: the dynamic shared memory limits of every
// instantiation, never inside a launch that a graph may capture.
extern "C" int mm_attention_bwd_init() {
  cudaError_t e = set_smem<64>();
  if (e == cudaSuccess) e = set_smem<96>();
  if (e == cudaSuccess) e = set_smem<128>();
  return static_cast<int>(e);
}
