// Device code shared by the one-launch self-attention blocks, sa_block
// (sa_block.cu) and sa_block_i8x (sa_block_i8x.cu): the kernels' parameters,
// the grid-wide barrier, the LayerNorm + modulation phase, the mma.sync GEMM
// tile of the two projections, the per-row quantisation of the attention
// output and the out-projection phase.
//
// A TPU program of the JAX experiments (scripts/exp_kernels.py) holds a
// whole sequence and the (E, 3E) weight in VMEM.  An H100 block holds 227 KB
// and the weight is 6 MB at E = 1024, so here one persistent launch of one
// 256-thread block per SM runs the block in phases, each walking its work
// over all blocks, with a grid-wide barrier between phases:
//   1. LayerNorm + modulation of the B * Tp padded rows (one warp a row),
//      with the per-row (or static) int8 quantisation of the W8A8 forms,
//      into device memory;
//   2. the merged QKV product (M = B * Tp, N = 3E, K = E), 128 x 128 tiles;
//   3. attention (in the kernel file);
//   3b. (W8A8) the attention output quantised per row, quant_rows'
//      arithmetic;
//   4. the out-projection, + bias, cast to bf16, then + residual (the JAX
//      kernels cast before they add), rows t < T only.
// The barrier is a counter and a generation number in device memory: each
// block's thread 0 arrives with an atomic add, the last to arrive resets
// the counter and bumps the generation, the others wait for the bump.  The
// counter returns to 0 at every barrier, so a launch needs no memset (and a
// CUDA graph no memset node).  It needs every block resident at once: the
// host sizes the grid from cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// and a cooperative launch is refused for a grid that does not fit instead
// of letting it hang.  One launch at a time per device (the barrier
// state is one global per kernel file).
//
// The products run on mma.sync m16n8k16 (bf16) or m16n8k32 (s8, s32 sums)
// tiles: 8 warps as 2 x 4, each 64 x 32 of the 128 x 128 tile; a 3-stage
// cp.async ring of 64-byte K slices (32 bf16 or 64 int8), rows padded to 80
// bytes so that the fragment loads (8 rows x 4 words) hit 32 banks.  A
// fragment's bytes sit at the same offsets for both types, so one loader
// serves both.  Reads of what another block wrote earlier in the launch go
// around L1 (cp.async.cg, __ldcg).
//
// Numerics as in the port's unfused kernels: the LayerNorm is adaln.cu's
// (same order of sums, one bf16 rounding of the modulated value), the
// quantisations quant_rows' (IEEE division, rintf), the dequantisations the
// JAX package's order, float(acc) * s_row * s_col + b, each step rounded on
// its own (__fmul_rn / __fadd_rn, no FMA contraction).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace mm {
namespace sa {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Bits of the launchers' flags argument (ops/sa_variants.py F_*).
constexpr int kQuant = 1;        // int8 weights, W8A8 products
constexpr int kRecip = 2;        // multiply by 1 / denominator
constexpr int kHeadBatch = 4;    // one attention unit per (sequence, query tile)
constexpr int kSkipLn = 8;       // xn = x
constexpr int kSkipAttn = 16;    // attention output = v
constexpr int kSkipSoftmax = 32;  // p = logits cast to bf16
constexpr int kRoundAttn = 64;   // quantise the attention output's bf16 rounding
constexpr int kResidual = 128;   // + x
constexpr int kZeroAttn = 256;   // torch's add_zero_attn
constexpr int kStatic = 512;     // sa_block_i8x: static activation scale
constexpr int kQpv = 1024;       // sa_block_i8x: int8 p.v
constexpr int kQqk = 2048;       // sa_block_i8x: int8 q.k^T

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;  // the bias of a masked (or padded) key

// GEMM tile: 128 x 128 outputs, K in 64-byte slices, 3 stages.
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kRowBytes = kBK + 16;
constexpr int kStages = 3;
constexpr int kStageBytes = (kBM + kBN) * kRowBytes;
constexpr int kGemmSmem = kStages * kStageBytes;

// Attention tile: 128 query rows (16 per warp), 64 keys per step.
constexpr int kQRows = 128;
constexpr int kKeys = 64;

// Shared memory of the attention phase: Q and K tiles with bf16 rows padded
// by 16 bytes, V transposed ([d][key], rows of 64 keys padded by 16 bytes),
// for sa_block_i8x a 16 x 64 int8 P tile per warp, the keys' biases.
__host__ __device__ constexpr int attn_smem_bytes(int D, bool i8x) {
  return kQRows * (2 * D + 16) + kKeys * (2 * D + 16) + D * (2 * kKeys + 16) +
         (i8x ? kWarps * 16 * (kKeys + 16) : 0) + 4 * kKeys;
}

__host__ __device__ constexpr int sa_smem_bytes(int D, bool i8x) {
  return kGemmSmem > attn_smem_bytes(D, i8x) ? kGemmSmem : attn_smem_bytes(D, i8x);
}

struct Params {
  const bf16* x;      // (B, T, E)
  const bf16* scale;  // (B, E), row stride lds
  long long lds;
  const bf16* shift;  // (B, E), row stride ldh
  long long ldh;
  const void* w_qkv;  // (3E, E) bf16, or int8 with kQuant
  const float* b_qkv;  // (3E,)
  const float* s_qkv;  // (3E,) int8 weight scales
  const void* w_o;    // (E, E) bf16, or int8
  const float* b_o;   // (E,)
  const float* s_o;   // (E,)
  const bool* kpm;    // (B, T), true = masked, or null
  bf16* out;          // (B, T, E)
  void* xn;           // (M, E) modulated rows: bf16, or int8 with kQuant
  float* xs;          // (M,) their scales (kQuant, not kStatic)
  void* qkv;          // (M, 3E): bf16 (sa_block) or f32 (sa_block_i8x)
  void* attn;         // (M, E): bf16, or f32 with kQuant
  int8_t* a8;         // (M, E) the attention output quantised (kQuant)
  float* as;          // (M,) its scales
  float* amax;        // (3, B) sa_block_i8x: max |q|, |k|, |v| per sequence
  int B, T, Tp, E, H, rows, flags;
  float attn_scale, eps, inv_static, static_as;
};

__device__ __forceinline__ uint32_t ld32(const char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A(16x32, row) * B(32x8, col), s8 inputs, s32 accumulate.
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
  mm::mma_16816(d, a, b);
}

__device__ __forceinline__ void mma(int* d, const uint32_t* a, const uint32_t* b) {
  mma_s8(d, a, b);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The grid-wide barrier (see the top of this file): bar[0] counts
// arrivals, bar[1] is the generation.
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g0 = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g0) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Phase 1: LayerNorm + modulation of the padded rows, one warp a row; lane l
// holds columns 256 c + 8 l (adaln.cu's layout and order of sums).  Rows
// t >= T are zero rows (LayerNorm 0, so they hold shift).  Writes bf16 xn,
// or with kQuant int8 rows and, unless kStatic, one scale per row.
// ---------------------------------------------------------------------------
inline __device__ void ln_phase(const Params& p) {
  const int lane = threadIdx.x & 31;
  const int E = p.E, M = p.B * p.Tp, f = p.flags;
  const float fe = static_cast<float>(E);
  for (int m = blockIdx.x * kWarps + (threadIdx.x >> 5); m < M; m += gridDim.x * kWarps) {
    const int b = m / p.Tp, t = m - b * p.Tp;
    float v[32];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 256 * c + 8 * lane;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (t < p.T && col < E)
        raw = *reinterpret_cast<const uint4*>(p.x + ((size_t)b * p.T + t) * E + col);
      mm::unpack_bf16x8(raw, v + 8 * c);
    }
    if (!(f & kSkipLn)) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (256 * (i / 8) + 8 * lane < E) sum = __fadd_rn(sum, v[i]);
      const float mean = __fdiv_rn(mm::warp_sum(sum), fe);
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        v[i] = __fsub_rn(v[i], mean);
        if (256 * (i / 8) + 8 * lane < E) sq = __fmaf_rn(v[i], v[i], sq);
      }
      const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(mm::warp_sum(sq), fe), p.eps));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 256 * c + 8 * lane;
        if (col >= E) continue;
        float s[8], h[8];
        mm::unpack_bf16x8(*reinterpret_cast<const uint4*>(p.scale + b * p.lds + col), s);
        mm::unpack_bf16x8(*reinterpret_cast<const uint4*>(p.shift + b * p.ldh + col), h);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[8 * c + i] = bf16_round(
              __fmaf_rn(__fmul_rn(v[8 * c + i], rstd), __fadd_rn(1.f, s[i]), h[i]));
      }
    }
    if (!(f & kQuant)) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 256 * c + 8 * lane;
        if (col >= E) continue;
        uint4 out;
        uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i] = mm::pack_bf16x2(v[8 * c + 2 * i], v[8 * c + 2 * i + 1]);
        *reinterpret_cast<uint4*>(static_cast<bf16*>(p.xn) + (size_t)m * E + col) = out;
      }
      continue;
    }
    float qs = 0.f;
    if (!(f & kStatic)) {
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (256 * (i / 8) + 8 * lane < E) amax = fmaxf(amax, fabsf(v[i]));
      qs = fmaxf(mm::warp_max(amax), 1e-8f) / 127.f;
      if (lane == 0) p.xs[m] = qs;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 256 * c + 8 * lane;
      if (col >= E) continue;
      uint32_t w[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = v[8 * c + 4 * j + i];
          uint32_t q;
          if (f & kStatic) {  // round(xn * (1 / static_as)), clipped
            const float r = fminf(fmaxf(rintf(__fmul_rn(x, p.inv_static)), -127.f), 127.f);
            q = static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
          } else {
            q = mm::q8(x, qs);
          }
          word |= q << (8 * i);
        }
        w[j] = word;
      }
      *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.xn) + (size_t)m * E + col) =
          make_uint2(w[0], w[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The GEMM tile: acc += A[m0:m0+128, :] . W[n0:n0+128, :]^T, A (M, K) and
// W (N, K) row-major with row strides in bytes, K = kbytes bytes (bf16 or
// int8 by the accumulator type).  Thread (warp w, lane g * 4 + t) holds
// acc[mi][ni][e] at row m0 + 64 (w / 4) + 16 mi + g + 8 (e / 2), column
// n0 + 32 (w % 4) + 8 ni + 2 t + e % 2.  Rows past M read as zeros; N is a
// multiple of 128 and kbytes of 64.
// ---------------------------------------------------------------------------
template <typename Acc>
__device__ __forceinline__ void gemm_tile(const char* __restrict__ A, long long lda,
                                          const char* __restrict__ W, long long ldw, int M,
                                          int kbytes, int m0, int n0, char* smem,
                                          Acc (&acc)[4][4][4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
  const int nk = kbytes / kBK;
  auto load = [&](int stage, int kt) {
    char* sa = smem + stage * kStageBytes;
    char* sw = sa + kBM * kRowBytes;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 2, col = (c & 3) * 16;
      const int gm = m0 + r;
      mm::cp_async16(sa + r * kRowBytes + col, A + (long long)min(gm, M - 1) * lda + kt * kBK + col,
                     gm < M ? 16 : 0);
      mm::cp_async16(sw + r * kRowBytes + col, W + (long long)(n0 + r) * ldw + kt * kBK + col, 16);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    mm::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    mm::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nk) load((kt + kStages - 1) % kStages, kt + kStages - 1);
    mm::cp_async_commit();
    const char* sa = smem + (kt % kStages) * kStageBytes;
    const char* sw = sa + kBM * kRowBytes;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const char* pa = sa + (wm * 64 + mi * 16 + g) * kRowBytes + kk * 32 + 4 * t;
        a[mi][0] = ld32(pa);
        a[mi][1] = ld32(pa + 8 * kRowBytes);
        a[mi][2] = ld32(pa + 16);
        a[mi][3] = ld32(pa + 8 * kRowBytes + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const char* pw = sw + (wn * 32 + ni * 8 + g) * kRowBytes + kk * 32 + 4 * t;
        b[ni][0] = ld32(pw);
        b[ni][1] = ld32(pw + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], a[mi], b[ni]);
    }
  }
  mm::cp_async_wait<0>();
  __syncthreads();
}

struct NoRowEnd {
  __device__ void operator()(int) const {}
};

// Every 128 x 128 tile of (M, N), walked over the grid, N-tiles fastest (the
// blocks at work at once share A's rows in L2); epi(row, col, v0, v1) gets
// each pair of columns (col, col + 1) of a row below M, dequantised to f32
// by deq(acc, row, col); row_end(row) follows each of the thread's rows of
// a tile, by every lane of the warp together (rows past M too).
template <typename Acc, typename Deq, typename Epi, typename RowEnd = NoRowEnd>
__device__ void gemm_phase(const char* A, long long lda, const char* W, long long ldw, int M,
                           int N, int kbytes, char* smem, Deq deq, Epi epi,
                           RowEnd row_end = RowEnd()) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int tiles_n = N / kBN, tiles = (M + kBM - 1) / kBM * tiles_n;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
    Acc acc[4][4][4];
    gemm_tile<Acc>(A, lda, W, ldw, M, kbytes, m0, n0, smem, acc);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mi * 16 + g + 8 * h;
        if (row < M) {
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int col = n0 + wn * 32 + ni * 8 + 2 * t;
            epi(row, col, deq(acc[mi][ni][2 * h], row, col),
                deq(acc[mi][ni][2 * h + 1], row, col + 1));
          }
        }
        row_end(row);
      }
  }
}

// The QKV product's dequantisation: bf16 products f32 sum + b; int8
// float(acc) * s_row * s_col + b, or with kStatic float(acc) * (s_col *
// static_as) + b (the JAX kernel's order in each).
struct QkvDeq {
  const Params* p;
  __device__ float operator()(float acc, int, int col) const {
    return __fadd_rn(acc, p->b_qkv[col]);
  }
  __device__ float operator()(int acc, int row, int col) const {
    const float a = static_cast<float>(acc);
    if (p->flags & kStatic)
      return __fadd_rn(__fmul_rn(a, __fmul_rn(p->s_qkv[col], p->static_as)), p->b_qkv[col]);
    return __fadd_rn(__fmul_rn(__fmul_rn(a, __ldcg(p->xs + row)), p->s_qkv[col]), p->b_qkv[col]);
  }
};

// The QKV product, each pair of outputs to store(row, col, v0, v1), then
// row_end(row) as gemm_phase calls it.
template <typename Store, typename RowEnd = NoRowEnd>
__device__ void qkv_phase(const Params& p, char* smem, Store store, RowEnd row_end = RowEnd()) {
  const int M = p.B * p.Tp, E = p.E;
  const QkvDeq deq{&p};
  if (p.flags & kQuant)
    gemm_phase<int>(static_cast<const char*>(p.xn), E, static_cast<const char*>(p.w_qkv), E, M,
                    3 * E, E, smem, deq, store, row_end);
  else
    gemm_phase<float>(static_cast<const char*>(p.xn), 2LL * E,
                      static_cast<const char*>(p.w_qkv), 2LL * E, M, 3 * E, 2 * E, smem, deq,
                      store, row_end);
}

// ---------------------------------------------------------------------------
// Phase 3b (kQuant): the attention output quantised per row, one warp a row,
// quant_rows' arithmetic: the f32 rows (rounded to bf16 first with
// kRoundAttn), or with kSkipAttn the bf16 v columns of the projection.
// ---------------------------------------------------------------------------
inline __device__ void quant_attn_phase(const Params& p) {
  const int lane = threadIdx.x & 31;
  const int E = p.E, M = p.B * p.Tp, f = p.flags;
  const bool from_v = f & kSkipAttn, to_bf16 = f & kRoundAttn;
  for (int m = blockIdx.x * kWarps + (threadIdx.x >> 5); m < M; m += gridDim.x * kWarps) {
    const float* a32 = static_cast<const float*>(p.attn) + (size_t)m * E;
    const bf16* v16 = static_cast<const bf16*>(p.qkv) + (size_t)m * 3 * E + 2 * E;
    auto load4 = [&](int c, float* x) {  // columns c..c+3
      if (from_v) {
        const uint2 u = __ldcg(reinterpret_cast<const uint2*>(v16 + c));
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
      } else {
        const float4 u = __ldcg(reinterpret_cast<const float4*>(a32 + c));
        x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
        if (to_bf16)
          for (int i = 0; i < 4; ++i) x[i] = bf16_round(x[i]);
      }
    };
    float amax = 0.f, x[4];
    for (int c = 4 * lane; c < E; c += 128) {
      load4(c, x);
      for (int i = 0; i < 4; ++i) amax = fmaxf(amax, fabsf(x[i]));
    }
    const float s = fmaxf(mm::warp_max(amax), 1e-8f) / 127.f;
    for (int c = 4 * lane; c < E; c += 128) {
      load4(c, x);
      *reinterpret_cast<uint32_t*>(p.a8 + (size_t)m * E + c) =
          mm::q8(x[0], s) | (mm::q8(x[1], s) << 8) | (mm::q8(x[2], s) << 16) |
          (mm::q8(x[3], s) << 24);
    }
    if (lane == 0) p.as[m] = s;
  }
}

// ---------------------------------------------------------------------------
// Phase 4: the out-projection: f32 y + b_o (int8: float(acc) * s_row *
// s_col + b_o), cast to bf16, + x in bf16 with kResidual; rows t < T.
// ---------------------------------------------------------------------------
struct OutDeq {
  const Params* p;
  __device__ float operator()(float acc, int, int col) const {
    return __fadd_rn(acc, p->b_o[col]);
  }
  __device__ float operator()(int acc, int row, int col) const {
    return __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(acc), __ldcg(p->as + row)),
                               p->s_o[col]),
                     p->b_o[col]);
  }
};

inline __device__ void out_phase(const Params& p, char* smem) {
  const int M = p.B * p.Tp, E = p.E, f = p.flags;
  auto store = [&](int row, int col, float y0, float y1) {
    const int b = row / p.Tp, t = row - b * p.Tp;
    if (t >= p.T) return;
    const size_t o = ((size_t)b * p.T + t) * E + col;
    __nv_bfloat162 y = __floats2bfloat162_rn(y0, y1);
    if (f & kResidual) {
      const float2 a = __bfloat1622float2(y);
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.x + o));
      y = __floats2bfloat162_rn(__fadd_rn(a.x, x.x), __fadd_rn(a.y, x.y));
    }
    *reinterpret_cast<__nv_bfloat162*>(p.out + o) = y;
  };
  const OutDeq deq{&p};
  if (f & kQuant) {
    gemm_phase<int>(reinterpret_cast<const char*>(p.a8), E, static_cast<const char*>(p.w_o), E,
                    M, E, E, smem, deq, store);
  } else if (f & kSkipAttn) {  // the v columns of the bf16 projection
    gemm_phase<float>(static_cast<const char*>(p.qkv) + 4LL * E, 6LL * E,
                      static_cast<const char*>(p.w_o), 2LL * E, M, E, 2 * E, smem, deq, store);
  } else {
    gemm_phase<float>(static_cast<const char*>(p.attn), 2LL * E, static_cast<const char*>(p.w_o),
                      2LL * E, M, E, 2 * E, smem, deq, store);
  }
}

// Launch on the caller's stream: grid blocks of kThreads with smem bytes of
// dynamic shared memory, cooperatively (refused for a grid the card cannot
// hold at once; the launch captures in a CUDA graph).
template <typename Kernel>
int launch(Kernel kernel, const Params& p, int grid, int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The arguments every launcher checks: E a multiple of 128 up to 1024, head
// dims 64 or 128, Tp a multiple of 8 that holds T, a grid.
inline bool shape_ok(int B, int T, int Tp, int E, int H, int grid) {
  return B >= 1 && T >= 1 && Tp >= T && Tp % 8 == 0 && E % 128 == 0 && E <= 1024 && H >= 1 &&
         E % H == 0 && (E / H == 64 || E / H == 128) && grid >= 1;
}

}  // namespace sa
}  // namespace mm
