// Device code shared by the one-launch self-attention blocks, sa_block
// (sa_block.cu) and sa_block_i8x (sa_block_i8x.cu): the kernels' parameters
// and tensor maps, the grid-wide barrier, the LayerNorm + modulation phase,
// the TMA + wgmma products, the per-row quantisation of the attention output
// and the out-projection's epilogue.
//
// A TPU program of the JAX experiments (scripts/exp_kernels.py) holds a
// whole sequence and the (E, 3E) weight in VMEM.  An H100 block holds 227 KB
// and the weight is 6 MB at E = 1024, so here one persistent launch of one
// 384-thread block per SM runs the block in phases, each walking its work
// over all blocks, with a grid-wide barrier between phases:
//   1. LayerNorm + modulation of the B * Tp padded rows (one warp a row),
//      with the per-row (or static) int8 quantisation of the W8A8 forms,
//      into device memory;
//   2. the merged QKV product (M = B * Tp, N = 3E, K = E), 128 x 128 tiles;
//   3. attention (in the kernel files);
//   3b. (W8A8) the attention output quantised per row, quant_rows'
//      arithmetic (the row maxima taken by the attention's epilogues);
//   4. the out-projection, + bias, cast to bf16, then + residual (the JAX
//      kernels cast before they add), rows t < T only.
// The barrier is a counter and a generation number in device memory: each
// block's thread 0 arrives with an atomic add, the last to arrive resets
// the counter and bumps the generation, the others wait for the bump.  The
// counter returns to 0 at every barrier, so a launch needs no memset (and a
// CUDA graph no memset node).  It needs every block resident at once: the
// host sizes the grid from cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// and a cooperative launch is refused for a grid that does not fit instead
// of letting it hang.  One launch at a time per device (the barrier state
// is one global per kernel file).
//
// The block: in the product phases warpgroup 0 is the producer (its
// thread 0 issues the TMA loads) and warpgroups 1 and 2 the consumers; in
// the attention phase all three take tiles, each issuing its own loads
// (sa_block.cu); all 12 warps run the row-wise phases 1 and 3b.  (No
// setmaxnreg: ptxas compiled the consumer code to the 168 registers of the
// launch bound whatever the increase asked, spilling the same, so the
// producer warpgroup keeps its registers for the other phases.)  The
// products are the shipped GEMM's main loop (gemm_sm90.cuh, whose
// primitives this file uses): TMA loads of 128-byte-deep K slabs of both
// operands with the 128-byte swizzle into a ring of kGemmStages stages on
// full / empty mbarrier pairs; each consumer warpgroup runs wgmma
// m64n128k16 (bf16) or m64n128k32 (s8) on its 64 rows of the 128 x 128
// tile.  The ring is not drained between tiles or between the two product
// phases: the producer keeps the next tile's slabs in flight through the
// current epilogue, and both sides carry their ring position from phase 2
// to phase 4.  The epilogue takes the tile's biases and column scales
// (loaded when the tile starts) from shared memory, stages the values
// through shared memory 128 bytes of each row at a time and writes 16-byte
// row pieces (the residual read before the chunk's stores).  The
// intermediates (xn, qkv, attn, a8) live in the wrapper's scratch, and
// their tensor maps are encoded on the host for each call and passed as
// __grid_constant__, so a captured graph holds them.  Around each barrier
// every thread fences its accesses against the async proxy, so the next
// phase's TMA loads see what other blocks wrote.
//
// Numerics as in the port's unfused kernels: the LayerNorm is adaln.cu's
// (same order of sums, one bf16 rounding of the modulated value), the
// quantisations quant_rows' (IEEE division, rintf), the dequantisations the
// JAX package's order, float(acc) * s_row * s_col + b, each step rounded on
// its own (__fmul_rn / __fadd_rn, no FMA contraction).  The bf16 products'
// f32 sums run in wgmma's order; int8 sums are exact.
#pragma once

#include <type_traits>

#include "gemm_sm90.cuh"

namespace mm {
namespace sa {

namespace sm90 = mm::sm90;

constexpr int kThreads = 384;        // producer warpgroup + two consumer warpgroups
constexpr int kWarps = kThreads / 32;  // the row-wise phases' warps: all of them

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

// The products: 128 x 128 output tiles, K in 128-byte slabs (64 bf16 or
// 128 int8), a ring of kGemmStages stages of both operands' slabs.
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kSlab = 128;
constexpr int kGemmStage = (kBM + kBN) * kSlab;
constexpr int kGemmStages = 6;
// Per consumer warpgroup, after the ring: the epilogue's staging of 64 rows
// of 128 bytes (rows padded by 16), then the tile's biases and column
// scales in f32.
constexpr int kEpiStride = 144;
constexpr int kEpiWgBytes = 64 * kEpiStride + 2 * kBN * 4;
constexpr int kGemmBytes = kGemmStages * kGemmStage + 2 * kEpiWgBytes;

// Attention: all three warpgroups of a block take attention tiles of 64
// query rows, each with its own Q tile and ring of K/V stages of 32 keys
// (in the shared memory of the products' ring, idle then), sized for bf16
// tiles (the int8 ones of sa_block_i8x are smaller).
constexpr int kAttnWarpgroups = kThreads / 128;
constexpr int kRows = 64;
constexpr int kKeys = 32;
constexpr int kBoxBytes = kRows * 128;    // a Q box: 64 rows of 128 bytes, one swizzled slab
constexpr int kKvBoxBytes = kKeys * 128;  // a K or V box: 32 rows of 128 bytes
constexpr int kMaxAttnStages = 6;
__host__ __device__ constexpr int attn_stages(int D) { return D == 64 ? 6 : 3; }
__host__ __device__ constexpr int q_tile_bytes(int D) { return kRows * 2 * D; }
__host__ __device__ constexpr int kv_stage_bytes(int D) { return 2 * kKeys * 2 * D; }
__host__ __device__ constexpr int attn_wg_bytes(int D) {
  return q_tile_bytes(D) + attn_stages(D) * kv_stage_bytes(D);
}
// After the rings, each warpgroup's staging of its output tile, 128 bytes
// of each of the 64 rows at a time (rows padded by 16).
constexpr int kStgBytes = kRows * kEpiStride;
__host__ __device__ constexpr int attn_bytes(int D) {
  return kAttnWarpgroups * (attn_wg_bytes(D) + kStgBytes);
}
__host__ __device__ constexpr int ring_bytes(int D) {
  return kGemmBytes > attn_bytes(D) ? kGemmBytes : attn_bytes(D);
}
// The mbarriers: the products' full / empty pairs, then per warpgroup its
// Q barrier and its K/V stages' (each warpgroup refills its own stages).
constexpr int kWgBarriers = 1 + kMaxAttnStages;
constexpr int kBarriers = 2 * kGemmStages + kAttnWarpgroups * kWgBarriers;

// Dynamic shared memory of one block: the 1024-byte alignment slack of the
// swizzle, the ring, the mbarriers (ops/sa_variants.py: sa_smem_bytes).
__host__ __device__ constexpr int sa_smem_bytes(int D) {
  return sm90::kSmemAlign + ring_bytes(D) + 8 * kBarriers;
}

struct Params {
  const bf16* x;      // (B, T, E)
  const bf16* scale;  // (B, E), row stride lds
  long long lds;
  const bf16* shift;  // (B, E), row stride ldh
  long long ldh;
  const float* b_qkv;  // (3E,)
  const float* s_qkv;  // (3E,) int8 weight scales
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
  float* ramax;       // (M,) kQuant: each row's max |value| over its heads, from the attention
  float* amax;        // (3, B) sa_block_i8x: max |q|, |k|, |v| per sequence
  void* qop;          // sa_block_i8x: attention's q operand (M, E), bf16 or int8
  void* kop;          // its k operand, the same
  void* vop;          // its v operand: (M, E) bf16, or int8 (B, H, D, Tv), keys permuted
  unsigned long long* stamps;  // (kStamps,) phase times of a reading, or null
  int B, T, Tp, Tv, E, H, rows, flags;
  float attn_scale, eps, inv_static, static_as;
};

// The tensor maps of a launch (encoded on the host, sa_block*.cu): the
// products' operands (row-major, 128-byte boxes of 128 rows), and the
// attention's q, k and v (sa_block: the packed projection, all three).
struct Maps {
  CUtensorMap xn, w_qkv, w_o, a_o, q, k, v;
};

// Position in a ring of stages: the stage and the parity of its phase.
struct Ring {
  int s = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next(int n) {
    if (++s == n) {
      s = 0;
      ph ^= 1;
    }
  }
};

// The block's shared memory: the ring (1024-aligned) and the mbarriers.
struct Smem {
  uint8_t* ring;
  uint8_t* epi;     // the products' epilogue staging, after their ring
  uint64_t* full;   // the products' ring
  uint64_t* empty;
  uint64_t* bars;   // per warpgroup: Q full, then K/V full[kMaxAttnStages]
  __device__ __forceinline__ uint64_t* qfull(int w) const { return bars + w * kWgBarriers; }
  __device__ __forceinline__ uint64_t* kvfull(int w) const { return qfull(w) + 1; }
  // Warpgroup w's Q tile and K/V stage st (K, then V at half).
  template <int D>
  __device__ __forceinline__ uint8_t* q_tile(int w) const {
    return ring + w * attn_wg_bytes(D);
  }
  template <int D>
  __device__ __forceinline__ uint8_t* kv_stage(int w, int st) const {
    return ring + w * attn_wg_bytes(D) + q_tile_bytes(D) + st * kv_stage_bytes(D);
  }
  template <int D>
  __device__ __forceinline__ uint8_t* attn_stg(int w) const {
    return ring + kAttnWarpgroups * attn_wg_bytes(D) + w * kStgBytes;
  }
};

// Carve the dynamic shared memory and initialise the mbarriers (the
// launch's first __syncthreads follows).
template <int D>
__device__ __forceinline__ Smem smem_layout(uint8_t* raw) {
  Smem m;
  m.ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + sm90::kSmemAlign - 1) &
                                      ~uintptr_t(sm90::kSmemAlign - 1));
  m.epi = m.ring + kGemmStages * kGemmStage;
  m.full = reinterpret_cast<uint64_t*>(m.ring + ring_bytes(D));
  m.empty = m.full + kGemmStages;
  m.bars = m.empty + kGemmStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      sm90::mbar_init(&m.full[s], 1);   // the producer's arrive, plus the TMA bytes
      sm90::mbar_init(&m.empty[s], 2);  // one arrive per consumer warpgroup
    }
    for (int i = 0; i < kAttnWarpgroups * kWgBarriers; ++i) sm90::mbar_init(&m.bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return m;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The attention loops hold their tiles as 32-bit shared addresses, and
// build the wgmma descriptors from them (kdesc_s, mndesc_s).
// An opaque copy of a 32-bit value: the compiler recomputes what it feeds
// where it is used instead of keeping the results of a loop's every
// iteration in registers across the loop (the descriptors of each k-step).
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// A K-major tile of rows of rb (32, 64 or 128) bytes, written by TMA with
// the swizzle of that width: 8-row atoms 8 rb bytes apart; a step along K
// adds its bytes >> 4 (sm90::sw128_desc for 128).
__device__ __forceinline__ uint64_t kdesc_s(uint32_t addr, int rb) {
  return ((addr >> 4) & 0x3FFF) | (uint64_t(1) << 16) | (uint64_t((8 * rb) >> 4) << 32) |
         (uint64_t(rb == 128 ? 1 : rb == 64 ? 2 : 3) << 62);
}

// MN-major, 128-byte swizzle, mn_stride bytes between 64-element blocks of
// N (sm90::sw128_desc_mn).
__device__ __forceinline__ uint64_t mndesc_s(uint32_t addr, uint32_t mn_stride) {
  return ((addr >> 4) & 0x3FFF) | (uint64_t((mn_stride >> 4) & 0x3FFF) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// Phase stamps (a reading, never a timed run: the wrapper passes a buffer
// only inside ops.sa_variants.phase_stamps()): %globaltimer in ns, slot 0
// when block 0 starts, slot i after the i-th grid barrier (block 0, thread
// 0), the last slot the latest block's end (atomicMax).
constexpr int kStamps = 8;

__device__ __forceinline__ void stamp(const Params& p, int i) {
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) p.stamps[i] = sm90::global_ns();
}

// Every thread of the block, after its last phase.
__device__ __forceinline__ void stamp_end(const Params& p) {
  if (p.stamps == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) atomicMax(p.stamps + kStamps - 1, sm90::global_ns());
}

// The grid-wide barrier (see the top of this file): bar[0] counts
// arrivals, bar[1] is the generation; then stamp ``++k``.  Every thread
// fences against the async proxy on both sides (the next phase's TMA loads
// read what this one wrote with plain stores).  A wait of more than 10 s
// can only be a fault: trap, so the launch fails instead of holding the
// card.
__device__ __forceinline__ void grid_sync(unsigned int* bar, const Params& p, int& k) {
  asm volatile("fence.proxy.async;\n" ::: "memory");
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
      uint64_t t0 = 0;
      for (uint32_t i = 1; *gen == g0; ++i) {
        __nanosleep(64);
        if ((i & 0xFFF) == 0) {
          const uint64_t now = sm90::global_ns();
          if (t0 == 0)
            t0 = now;
          else if (now - t0 > 10000000000ull)
            asm volatile("trap;");
        }
      }
    }
    __threadfence();
  }
  __syncthreads();
  asm volatile("fence.proxy.async;\n" ::: "memory");
  stamp(p, ++k);
}

// ---------------------------------------------------------------------------
// Phase 1 (every warp): LayerNorm + modulation of the padded rows, one
// warp a row; lane l holds columns
// 256 c + 8 l (adaln.cu's layout and order of sums).  Rows t >= T are zero
// rows (LayerNorm 0, so they hold shift).  Writes bf16 xn, or with kQuant
// int8 rows and, unless kStatic, one scale per row.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ln_row(const Params& p, int m, float* v) {
  const int lane = threadIdx.x & 31;
  const int E = p.E, f = p.flags, b = m / p.Tp;
  const float fe = static_cast<float>(E);
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
        v[8 * c + i] =
            bf16_round(__fmaf_rn(__fmul_rn(v[8 * c + i], rstd), __fadd_rn(1.f, s[i]), h[i]));
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
    return;
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

__device__ __forceinline__ void ln_phase(const Params& p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int E = p.E, M = p.B * p.Tp;
  for (int m = blockIdx.x * kWarps + warp; m < M; m += gridDim.x * kWarps) {
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
    ln_row(p, m, v);
    if (lane == 0 && p.ramax != nullptr) p.ramax[m] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// The products.  Every 128 x 128 tile of (M, N), walked over the grid,
// N-tiles fastest (the blocks at work at once share A's rows in L2); A
// (M, K) and W (N, K) K-contiguous behind tensor maps of 128-byte boxes of
// 128 rows (rows past M zero-filled); K = kbytes bytes.
// ---------------------------------------------------------------------------

struct Tiles {
  int tiles_n, tiles, kt;
  __device__ __forceinline__ Tiles(int M, int N, int kbytes)
      : tiles_n(N / kBN), tiles((M + kBM - 1) / kBM * (N / kBN)), kt(kbytes / kSlab) {}
};

// The producer thread: each slab of each of this block's tiles into the
// ring, once the consumers have released its stage.
__device__ __forceinline__ void gemm_produce(const CUtensorMap* a, const CUtensorMap* w, int M,
                                             int N, int kbytes, int elem_bytes, const Smem& sm,
                                             Ring& r) {
  const Tiles tl(M, N, kbytes);
  const int kel = kSlab / elem_bytes;
  for (int tile = blockIdx.x; tile < tl.tiles; tile += gridDim.x) {
    const int m0 = tile / tl.tiles_n * kBM, n0 = tile % tl.tiles_n * kBN;
    for (int kt = 0; kt < tl.kt; ++kt) {
      sm90::mbar_wait(&sm.empty[r.s], r.ph ^ 1);
      uint8_t* st = sm.ring + r.s * kGemmStage;
      sm90::mbar_expect_tx(&sm.full[r.s], kGemmStage);
      sm90::tma_load_2d(st, a, &sm.full[r.s], kt * kel, m0);
      sm90::tma_load_2d(st + kBM * kSlab, w, &sm.full[r.s], kt * kel, n0);
      r.next(kGemmStages);
    }
  }
}

// The epilogue's inputs of one tile, loaded when the tile starts so that
// their latency hides behind the main loop: thread tid of a consumer
// warpgroup takes column n0 + tid's bias and scale (the int8 weight's, times
// static_as with kStatic; 1 for bf16), and its two rows' scales (the int8
// activations' per-row ones).
enum Deq { kDeqBf16 = 0, kDeqRow = 1, kDeqStatic = 2 };

struct TileIn {
  float bias, cscale, rscale[2];
  __device__ __forceinline__ void load(int deq, const float* b, const float* cs, float cmul,
                                       const float* rs, int M, int n0, int row0, int tid) {
    bias = b[n0 + tid];
    cscale = deq == kDeqBf16     ? 1.f
             : deq == kDeqStatic ? __fmul_rn(cs[n0 + tid], cmul)
                                 : cs[n0 + tid];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rscale[h] = deq == kDeqRow && row0 + 8 * h < M ? __ldcg(rs + row0 + 8 * h) : 0.f;
  }
};

// One sum of the product dequantised: bf16 products f32 sum + b; int8
// float(acc) * s_row * s_col + b, or with kStatic float(acc) * (s_col *
// static_as) + b (the JAX kernels' order in each, each step rounded).
__device__ __forceinline__ float dequant(float acc, int, float, float, float b) {
  return __fadd_rn(acc, b);
}
__device__ __forceinline__ float dequant(int acc, int deq, float rs, float cs, float b) {
  const float a = static_cast<float>(acc);
  if (deq == kDeqStatic) return __fadd_rn(__fmul_rn(a, cs), b);
  return __fadd_rn(__fmul_rn(__fmul_rn(a, rs), cs), b);
}

// What the epilogue calls besides the staging: value(h, v0, v1) for each
// pair of the thread's row h (below M), then row_end(h, row, n0) for both
// its rows, by every lane of the warp together (rows past M too).
struct NoHook {
  __device__ void value(int, float, float) {}
  __device__ void row_end(int, int, int) {}
};

// One consumer warpgroup's 64 x kBN slab of a product tile (rows m0..,
// columns n0..) from its wgmma fragment (thread (warp w, lane 4 g + t)
// holds rows 16 w + g + 8 h, columns 8 j + 2 t (+1)): dequantised, staged
// through shared memory 128 bytes of each row at a time (64 bf16 or, with
// kF32, 32 f32 columns), and written as 16-byte row pieces:
// out.store(row, col, piece, pre, kF32) for rows below M (the values of
// columns col..), where pre = out.load(row, col) (the residual); a
// thread's four loads are issued before any of its stores.
template <bool kF32, typename Acc, typename Out, typename Hook>
__device__ __forceinline__ void tile_epilogue(const Acc* acc, const TileIn& in, int deq, int M,
                                              int m0, int n0, uint8_t* stg, int bar, Out& out,
                                              Hook& hook) {
  constexpr int kOut = kF32 ? 4 : 2, kCols = 128 / kOut;  // a chunk: 128 bytes of each row
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
  float* vec = reinterpret_cast<float*>(stg + 64 * kEpiStride);
  sm90::named_sync(bar);  // the previous tile's last pieces are out
  vec[tid] = in.bias;
  vec[kBN + tid] = in.cscale;
  sm90::named_sync(bar);
#pragma unroll
  for (int ch = 0; ch < kBN / kCols; ++ch) {
#pragma unroll
    for (int jj = 0; jj < kCols / 8; ++jj) {
      const int j = ch * (kCols / 8) + jj, c = jj * 8 + 2 * t, tc = ch * kCols + c;
      const float2 b2 = *reinterpret_cast<const float2*>(vec + tc);
      const float2 c2 = *reinterpret_cast<const float2*>(vec + kBN + tc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = dequant(acc[4 * j + 2 * h], deq, in.rscale[h], c2.x, b2.x);
        const float v1 = dequant(acc[4 * j + 2 * h + 1], deq, in.rscale[h], c2.y, b2.y);
        if (m0 + r0 + 8 * h < M) hook.value(h, v0, v1);
        uint8_t* q = stg + (r0 + 8 * h) * kEpiStride + c * kOut;
        if constexpr (kF32)
          *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(q) = mm::pack_bf16x2(v0, v1);
      }
    }
    sm90::named_sync(bar);
    // 64 rows x 8 pieces of 16 bytes, four pieces per thread: piece i is
    // row i / 8, bytes (i % 8) * 16 of the chunk.
    uint4 pre[4];
#pragma unroll
    for (int pc = 0; pc < 4; ++pc) {
      const int i = tid + 128 * pc, row = m0 + (i >> 3);
      pre[pc] = row < M ? out.load(row, n0 + ch * kCols + (i & 7) * (16 / kOut))
                        : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int pc = 0; pc < 4; ++pc) {
      const int i = tid + 128 * pc, rr = i >> 3, row = m0 + rr;
      if (row < M)
        out.store(row, n0 + ch * kCols + (i & 7) * (16 / kOut),
                  *reinterpret_cast<const uint4*>(stg + rr * kEpiStride + (i & 7) * 16), pre[pc],
                  kF32);
    }
    sm90::named_sync(bar);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) hook.row_end(h, m0 + r0 + 8 * h, n0);
}

// A consumer warpgroup's product phase: its 64 rows of each tile on wgmma,
// then tile_epilogue, staging f32 where out.f32(n0) (the tile's columns
// are kept in f32) and bf16 elsewhere.
template <typename Acc, typename Out, typename Hook = NoHook>
__device__ __forceinline__ void gemm_consume(int M, int N, int kbytes, int deq, const float* bias,
                                             const float* cscale, float cmul,
                                             const float* rscale, const Smem& sm, Ring& r,
                                             Out out, Hook hook = Hook()) {
  const Tiles tl(M, N, kbytes);
  const int tid = threadIdx.x & 127, cw = (threadIdx.x >> 7) - 1;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
  uint8_t* stg = sm.epi + cw * kEpiWgBytes;
  Acc acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
  for (int tile = blockIdx.x; tile < tl.tiles; tile += gridDim.x) {
    const int m0 = tile / tl.tiles_n * kBM + cw * 64, n0 = tile % tl.tiles_n * kBN;
    TileIn in;
    in.load(deq, bias, cscale, cmul, rscale, M, n0, m0 + r0, tid);
    int prev = 0;
    for (int kt = 0; kt < tl.kt; ++kt) {
      sm90::mbar_wait(&sm.full[r.s], r.ph);
      const uint8_t* st = sm.ring + r.s * kGemmStage;
      const uint64_t da = sm90::sw128_desc(st + cw * 64 * kSlab);
      const uint64_t db = sm90::sw128_desc(st + kBM * kSlab);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sm90::reg_fence(acc[i]);
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) sm90::mma<kBN>(acc, da + 2 * k, db + 2 * k, (kt | k) != 0);
      sm90::wgmma_commit();
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sm90::reg_fence(acc[i]);
      // The previous stage's products are done once at most this group is
      // in flight: hand that stage back to the producer.
      sm90::wgmma_wait<1>();
      if (kt > 0 && tid == 0) sm90::mbar_arrive(&sm.empty[prev]);
      prev = r.s;
      r.next(kGemmStages);
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sm90::reg_fence(acc[i]);
    if (tid == 0) sm90::mbar_arrive(&sm.empty[prev]);
    if (out.f32(n0))
      tile_epilogue<true>(acc, in, deq, M, m0, n0, stg, 1 + cw, out, hook);
    else
      tile_epilogue<false>(acc, in, deq, M, m0, n0, stg, 1 + cw, out, hook);
  }
}

// Phase 2, the producer's side.
__device__ __forceinline__ void qkv_produce(const Maps& maps, const Params& p, const Smem& sm,
                                            Ring& r) {
  const bool q8 = p.flags & kQuant;
  gemm_produce(&maps.xn, &maps.w_qkv, p.B * p.Tp, 3 * p.E, q8 ? p.E : 2 * p.E, q8 ? 1 : 2, sm,
               r);
}

// A row-major bf16 (M, ld) output of a product: 16-byte pieces stored as
// they are, nothing read before.
struct RowsOut {
  bf16* y;
  int ld;
  __device__ __forceinline__ bool f32(int) const { return false; }
  __device__ __forceinline__ uint4 load(int, int) const { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void store(int row, int col, uint4 v, uint4, bool) const {
    *reinterpret_cast<uint4*>(y + (size_t)row * ld + col) = v;
  }
};

// Phase 2, a consumer's side: the QKV product to out, with the hook.
template <typename Out, typename Hook = NoHook>
__device__ __forceinline__ void qkv_consume(const Params& p, const Smem& sm, Ring& r, Out out,
                                            Hook hook = Hook()) {
  const int M = p.B * p.Tp, E = p.E;
  if (p.flags & kQuant)
    gemm_consume<int>(M, 3 * E, E, p.flags & kStatic ? kDeqStatic : kDeqRow, p.b_qkv, p.s_qkv,
                      p.static_as, p.xs, sm, r, out, hook);
  else
    gemm_consume<float>(M, 3 * E, 2 * E, kDeqBf16, p.b_qkv, nullptr, 1.f, nullptr, sm, r, out,
                        hook);
}

// ---------------------------------------------------------------------------
// Phase 3b (kQuant, every thread): the attention output quantised per row,
// quant_rows' arithmetic: scale max(amax, 1e-8) / 127, int8 rint(value /
// scale) clipped.  The attention's epilogue took each row's amax over its
// heads (row_max_out), so here every thread takes 8 values of a row at a
// time: the f32 rows, rounded to bf16 first with kRoundAttn.  With
// kSkipAttn (the bf16 v columns of the projection, no attention) one warp
// takes a row, read once into registers, and reduces it first.
// ---------------------------------------------------------------------------

// A consumer warpgroup's attention tile: its rows' max |value| over this
// head (amax[i] of the thread's row g + 8 i) into ramax, one atomicMax on
// the float bits per row (values >= 0 order as their bits).
__device__ __forceinline__ void row_max_out(const Params& p, float* amax, int b, int q0) {
  const int tid = threadIdx.x & 127, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 1));
    amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 2));
    const int row = q0 + (tid >> 5) * 16 + (lane >> 2) + 8 * i;
    if ((lane & 3) == 0 && row < p.Tp)
      atomicMax(reinterpret_cast<unsigned int*>(p.ramax) + (size_t)b * p.Tp + row,
                __float_as_uint(amax[i]));
  }
}

__device__ __forceinline__ void quant_attn_phase(const Params& p) {
  const int E = p.E, M = p.B * p.Tp, f = p.flags;
  if (!(f & kSkipAttn)) {
    const bool to_bf16 = f & kRoundAttn;
    const int groups = M * (E / 8);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < groups; i += gridDim.x * kThreads) {
      const int m = i / (E / 8), c = (i - m * (E / 8)) * 8;
      const float s = fmaxf(__ldcg(p.ramax + m), 1e-8f) / 127.f;
      const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(p.attn) +
                                                          (size_t)m * E + c);
      float4 u[2] = {__ldcg(src), __ldcg(src + 1)};
      uint32_t w[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float y[4] = {u[k].x, u[k].y, u[k].z, u[k].w};
        if (to_bf16)
          for (int e = 0; e < 4; ++e) y[e] = bf16_round(y[e]);
        w[k] = mm::q8(y[0], s) | (mm::q8(y[1], s) << 8) | (mm::q8(y[2], s) << 16) |
               (mm::q8(y[3], s) << 24);
      }
      *reinterpret_cast<uint2*>(p.a8 + (size_t)m * E + c) = make_uint2(w[0], w[1]);
      if (c == 0) p.as[m] = s;
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = blockIdx.x * kWarps + warp; m < M; m += gridDim.x * kWarps) {
    const bf16* v16 = static_cast<const bf16*>(p.qkv) + (size_t)m * 3 * E + 2 * E;
    float x[32];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = 4 * lane + 128 * k;
      float* y = x + 4 * k;
      y[0] = y[1] = y[2] = y[3] = 0.f;
      if (c >= E) continue;
      const uint2 u = __ldcg(reinterpret_cast<const uint2*>(v16 + c));
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      y[0] = lo.x, y[1] = lo.y, y[2] = hi.x, y[3] = hi.y;
    }
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) amax = fmaxf(amax, fabsf(x[i]));
    const float s = fmaxf(mm::warp_max(amax), 1e-8f) / 127.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = 4 * lane + 128 * k;
      if (c >= E) continue;
      const float* y = x + 4 * k;
      *reinterpret_cast<uint32_t*>(p.a8 + (size_t)m * E + c) =
          mm::q8(y[0], s) | (mm::q8(y[1], s) << 8) | (mm::q8(y[2], s) << 16) |
          (mm::q8(y[3], s) << 24);
    }
    if (lane == 0) p.as[m] = s;
  }
}

// ---------------------------------------------------------------------------
// Phase 4: the out-projection: f32 y + b_o (int8: float(acc) * s_row *
// s_col + b_o), cast to bf16, + x in bf16 with kResidual; rows t < T.  Its
// A operand (maps.a_o) is a8 (kQuant), the v columns of the bf16 projection
// (kSkipAttn) or the bf16 attention output.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void out_produce(const Maps& maps, const Params& p, const Smem& sm,
                                            Ring& r) {
  const bool q8 = p.flags & kQuant;
  gemm_produce(&maps.a_o, &maps.w_o, p.B * p.Tp, p.E, q8 ? p.E : 2 * p.E, q8 ? 1 : 2, sm, r);
}

// The out-projection's output: rows t < T of each sequence, the bf16 value
// + the residual x (read before the staging) in bf16 with kResidual.
struct ResidualOut {
  const bf16* x;
  bf16* out;
  int T, Tp, E;
  bool residual;
  __device__ __forceinline__ size_t at(int row, int col, bool* keep) const {
    const int b = row / Tp, t = row - b * Tp;
    *keep = t < T;
    return ((size_t)b * T + t) * E + col;
  }
  __device__ __forceinline__ bool f32(int) const { return false; }
  __device__ __forceinline__ uint4 load(int row, int col) const {
    bool keep;
    const size_t o = at(row, col, &keep);
    return residual && keep ? *reinterpret_cast<const uint4*>(x + o) : make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ void store(int row, int col, uint4 v, uint4 xr, bool) const {
    bool keep;
    const size_t o = at(row, col, &keep);
    if (!keep) return;
    if (residual) {
      __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(&v);
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&xr);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(y[i]), b = __bfloat1622float2(xv[i]);
        y[i] = __floats2bfloat162_rn(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
      }
    }
    *reinterpret_cast<uint4*>(out + o) = v;
  }
};

__device__ __forceinline__ void out_consume(const Params& p, const Smem& sm, Ring& r) {
  const int M = p.B * p.Tp, E = p.E;
  const ResidualOut out{p.x, p.out, p.T, p.Tp, E, (p.flags & kResidual) != 0};
  if (p.flags & kQuant)
    gemm_consume<int>(M, E, E, kDeqRow, p.b_o, p.s_o, 1.f, p.as, sm, r, out);
  else
    gemm_consume<float>(M, E, 2 * E, kDeqBf16, p.b_o, nullptr, 1.f, nullptr, sm, r, out);
}

// ---------------------------------------------------------------------------
// Attention, shared by both kernels
// ---------------------------------------------------------------------------

// The mask bits of this thread's 8 keys k0 + 8 (c / 2) + 2 t + c % 2 of a
// 32-key step of a sequence (kpm_b: its mask bytes, or null), bit c set
// where the key is masked; read with unconditional loads (clamped to the
// row), so that all 8 are in flight at once.
__device__ __forceinline__ uint32_t key_mask(const bool* kpm_b, int T, int k0, int t) {
  uint32_t m = 0;
  if (kpm_b != nullptr) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      m |= static_cast<uint32_t>(kpm_b[min(k0 + (c >> 1) * 8 + 2 * t + (c & 1), T - 1)]) << c;
  }
  return m;
}

// The bias of logit s[i] of a step (key k0 + 8 (i / 4) + 2 t + i % 2): -inf
// past Tp, -1e30 at padded (T <= key < Tp) and masked keys, else 0.
__device__ __forceinline__ float key_bias(uint32_t mask, int i, int k0, int t, int T, int Tp) {
  const int c = 2 * (i >> 2) + (i & 1), key = k0 + (c >> 1) * 8 + 2 * t + (c & 1);
  return key >= Tp ? -INFINITY : (key >= T || ((mask >> c) & 1)) ? kMasked : 0.f;
}

// A warpgroup's 64-row attention output tile through ``stg`` (64 rows of
// kEpiStride bytes; 128 bytes of each row at a time, f32 or, unless kF32,
// bf16): val(c, i, y0, y1) gives the thread's values at row g + 8 i of its
// warp, columns 8 c + 2 t and + 1; the first ``rows`` rows go out as
// 16-byte pieces to dst + r * ld (elements).
template <bool kF32, int D, typename Val>
__device__ __forceinline__ void stage_out(uint8_t* stg, int bar, Val val, void* dst, size_t ld,
                                          int rows) {
  constexpr int kOut = kF32 ? 4 : 2, kCols = 128 / kOut;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int ch = 0; ch < D / kCols; ++ch) {
#pragma unroll
    for (int jj = 0; jj < kCols / 8; ++jj) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float y0, y1;
        val(ch * (kCols / 8) + jj, i, y0, y1);
        uint8_t* q = stg + (r0 + 8 * i) * kEpiStride + (jj * 8 + 2 * t) * kOut;
        if constexpr (kF32)
          *reinterpret_cast<float2*>(q) = make_float2(y0, y1);
        else
          *reinterpret_cast<uint32_t*>(q) = mm::pack_bf16x2(y0, y1);
      }
    }
    sm90::named_sync(bar);
#pragma unroll
    for (int pc = 0; pc < 4; ++pc) {
      const int i = tid + 128 * pc, rr = i >> 3;
      if (rr < rows) {
        uint8_t* d = static_cast<uint8_t*>(dst) + ((size_t)rr * ld + ch * kCols) * kOut;
        *reinterpret_cast<uint4*>(d + (i & 7) * 16) =
            *reinterpret_cast<const uint4*>(stg + rr * kEpiStride + (i & 7) * 16);
      }
    }
    sm90::named_sync(bar);
  }
}

// The attention tiles of warpgroup gw of the grid's kAttnWarpgroups *
// gridDim.x (warpgroup w of block i is w * gridDim.x + i): units gw,
// gw + 3 gridDim.x, ...; a unit is (group of ``rows`` sequences, head,
// 64-row query tile), or with kHeadBatch (group, query tile) over all
// heads, and walks its sequences and heads in turn, so the output does not
// depend on the schedule.  count() tiles, tile(n) the n-th.
struct Walk {
  int gw, stride, QT, HU, per_unit, rows, H, units;
  bool hb;
  __device__ __forceinline__ Walk(const Params& p, int gw_)
      : gw(gw_),
        stride(kAttnWarpgroups * gridDim.x),
        QT((p.Tp + kRows - 1) / kRows),
        HU(p.flags & kHeadBatch ? 1 : p.H),
        per_unit(p.flags & kHeadBatch ? p.rows * p.H : p.rows),
        rows(p.rows),
        H(p.H),
        units((p.B / p.rows) * (p.flags & kHeadBatch ? 1 : p.H) * ((p.Tp + kRows - 1) / kRows)),
        hb(p.flags & kHeadBatch) {}
  __device__ __forceinline__ int count() const {
    return gw < units ? (units - gw + stride - 1) / stride * per_unit : 0;
  }
  __device__ __forceinline__ void tile(int n, int& b, int& h, int& q0) const {
    const int k = n / per_unit, r = n - k * per_unit, u = gw + k * stride;
    const int qt = u % QT, hu = (u / QT) % HU, bg = u / (QT * HU);
    const int nh = hb ? H : 1, rr = r / nh;
    b = bg * rows + rr;
    h = hb ? r - rr * nh : hu;
    q0 = qt * kRows;
  }
};

// Q K^T of one 32-key step: D(64 x 32) (+)= A . B^T, bf16 with f32 sums
// (m64n32k16) or s8 with s32 sums (m64n32k32), both operands K-major in
// shared memory.  A thread holds d[4 c + e] at row g + 8 (e / 2) of its
// warp's 16, key 8 c + 2 t + e % 2 of the step.
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The running softmax state of a thread's two rows (g and g + 8 of its
// warp's 16): max and the sum over this thread's quarter of the keys, so
// the zero key's 1 goes to one lane of the four.
struct Online {
  float m[2], l[2];
  __device__ __forceinline__ void start(bool zero_attn, int t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = zero_attn ? 0.f : -INFINITY;
      l[i] = (zero_attn && t == 0) ? 1.f : 0.f;
    }
  }
  // A step's 8 logits per row (s[4 c + e]: row e / 2, key 8 c + 2 t + e % 2):
  // the new max, the rescale of l (returned as alpha for the output), and
  // mref, the max the exponents subtract (0 for a row with no finite logit).
  __device__ __forceinline__ void update(const float* s, float* mref, float* alpha) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 16; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mnew = fmaxf(m[i], mx[i]);
      mref[i] = mnew == -INFINITY ? 0.f : mnew;
      alpha[i] = ex2((m[i] - mref[i]) * kLog2e);
      m[i] = mnew;
      l[i] *= alpha[i];
    }
  }
  // The quad's sum of l (every lane gets its row's denominator).
  __device__ __forceinline__ void reduce() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
  }
};

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The arguments every launcher checks: E a multiple of 128 up to 1024, head
// dims 64 or 128, Tp a multiple of 8 that holds T, a grid.
inline bool shape_ok(int B, int T, int Tp, int E, int H, int grid) {
  return B >= 1 && T >= 1 && Tp >= T && Tp % 8 == 0 && E % 128 == 0 && E <= 1024 && H >= 1 &&
         E % H == 0 && (E / H == 64 || E / H == 128) && grid >= 1;
}

// A tensor map with the swizzle of ``swizzle_bytes`` (128: through the
// shipped GEMM's cache, sm90::tensor_map; 64 or 32: encoded here), zero
// fill out of bounds.  False if the driver refuses.
inline bool encode_map(CUtensorMap* out, CUtensorMapDataType dtype, const void* ptr, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                       int swizzle_bytes) {
  if (swizzle_bytes == 128) return sm90::tensor_map(out, dtype, ptr, rank, dims, strides, box);
  const sm90::EncodeTiledFn encode = sm90::encode_tiled();
  if (encode == nullptr || (swizzle_bytes != 64 && swizzle_bytes != 32)) return false;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(out, dtype, rank, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The first ``cols`` columns of a row-major (B, Tp, ld) tensor as the 3-D
// map {cols, Tp, B}: boxes of box_cols columns by box_rows rows of one
// sequence (rows past Tp zero-filled), swizzled by the box's row bytes (64
// or 128).
inline bool rows_map(CUtensorMap* m, CUtensorMapDataType dtype, const void* ptr, int cols, int ld,
                     int Tp, int B, int elem_bytes, unsigned box_cols, unsigned box_rows) {
  const cuuint64_t row = static_cast<cuuint64_t>(ld) * elem_bytes;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(Tp),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {row, row * Tp};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  return encode_map(m, dtype, ptr, 3, dims, strides, box, static_cast<int>(box_cols) * elem_bytes);
}

// The products' maps: xn, w_qkv and w_o (bf16, or int8 with kQuant) and the
// out-projection's A operand (a8; the v columns of the packed bf16
// projection with kSkipAttn; the bf16 attention output), in 128-byte boxes
// of 128 rows.
inline bool product_maps(Maps* m, const Params& p, const void* w_qkv, const void* w_o) {
  const bool q8 = p.flags & kQuant;
  const auto dt = q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const unsigned eb = q8 ? 1 : 2, bk = kSlab / eb;
  const unsigned long long M = static_cast<unsigned long long>(p.B) * p.Tp, E = p.E;
  bool ok = sm90::tensor_map_2d(&m->xn, dt, p.xn, E, M, E * eb, bk, kBM) &&
            sm90::tensor_map_2d(&m->w_qkv, dt, w_qkv, E, 3 * E, E * eb, bk, kBN) &&
            sm90::tensor_map_2d(&m->w_o, dt, w_o, E, E, E * eb, bk, kBN);
  if (q8)
    return ok && sm90::tensor_map_2d(&m->a_o, dt, p.a8, E, M, E, bk, kBM);
  if (p.flags & kSkipAttn)
    return ok && sm90::tensor_map_2d(&m->a_o, bf, static_cast<const bf16*>(p.qkv) + 2 * E, E, M,
                                     6 * E, bk, kBM);
  return ok && sm90::tensor_map_2d(&m->a_o, bf, p.attn, E, M, 2 * E, bk, kBM);
}

// Launch on the caller's stream: grid blocks of kThreads with smem bytes of
// dynamic shared memory, cooperatively (refused for a grid the card cannot
// hold at once; the launch captures in a CUDA graph).
template <typename Kernel>
int launch(Kernel kernel, const Maps& m, const Params& p, int grid, int smem,
           cudaStream_t stream) {
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, m, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sa
}  // namespace mm
