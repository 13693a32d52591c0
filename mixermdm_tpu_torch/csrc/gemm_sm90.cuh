// One Hopper GEMM main loop, shared by linear_epilogue (bf16 operands, f32
// sums; csrc/linear.cu) and linear_q8 (int8 operands, s32 sums;
// csrc/linear_q8.cu): y = epilogue(x . w^T) with x (M, K) and w (N, K), both
// K-contiguous (torch's Linear layout, the K-major form int8 wgmma needs).
//
// What bounds it: at the denoiser shapes (M = 2392, N and K 512-3072)
// tensor-core operations, 989 TFLOP/s bf16 and 1979 TOP/s int8 on an H100 SXM,
// which only wgmma reaches, fed from L2 at 48 KB per 4.2 MFLOP by the 128 x 256
// tile.  What this design leaves on the table is the epilogue: both consumer
// warpgroups run it between two tiles' main loops, with the tensor cores
// idle (erff's GELU and the int8 dequantisation cost most).  The design:
//
// - Loads.  TMA copies 128-byte-deep K slabs of both operands (BK = 64 bf16
//   or 128 int8) into shared memory with the 128-byte swizzle that wgmma's
//   descriptors read without bank conflicts.  Out-of-bounds rows and the K
//   tail are zero-filled by the TMA unit, so ragged M, N and K need no code.
// - Pipeline.  A ring of 4-6 stages, each guarded by a full / empty mbarrier
//   pair.  One producer warp issues cp.async.bulk.tensor and gives its
//   registers to the two consumer warpgroups (setmaxnreg); each consumer
//   warpgroup runs m64nBNk16 (bf16) or m64nBNk32 (s8) wgmma on its 64 rows of
//   the 128 x BN tile, keeping one group in flight while the next stage lands.
//   The K sum runs in k16 steps from k = 0 up.
// - Grid.  Persistent: min(tiles, SMs) blocks walk the output tiles M-first,
//   so the blocks running at one time share W tiles in L2, and the producer
//   loads the next tile's first stages while the consumers run an epilogue.
// - Epilogue.  Bias and column scales are loaded when a tile starts (their
//   latency hides behind the main loop), the residual tile is prefetched into
//   L2; GELU is a compile-time variant, so no other epilogue carries erff's
//   code.  Each consumer warpgroup stages 128 bytes of each of its 64
//   rows at a time through shared memory and writes them back as 16-byte row
//   pieces (coalesced), reading the residual the same way.
//
// The tile width BN (64, 128, 192 or 256), the stage count, the grid and the
// shared memory size are chosen on the host (ops/linear.py: gemm_plan) and
// passed in; smem_bytes() here is the same formula, checked at launch.
// The TMA descriptors are encoded on the host with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint (no -lcuda), cached on their full
// key, and passed by value as __grid_constant__ parameters, so a captured
// CUDA graph holds them.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, the driver is reached at run time

#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace mm {
namespace sm90 {

constexpr int BM = 128;                // two consumer warpgroups of 64 rows
constexpr int kRowBytes = 128;         // K depth of a stage, in bytes
constexpr int kThreads = 384;          // producer warpgroup + two consumer warpgroups
constexpr int kEpiStride = 144;        // staging row stride in bytes: 128 + 16 of padding
constexpr int kMaxBN = 256;
// Per consumer warpgroup: the staging of one chunk, then the tile's bias and
// column scales in f32.
constexpr int kEpiWgBytes = 64 * kEpiStride + 2 * kMaxBN * 4;
constexpr int kEpiBytes = 2 * kEpiWgBytes;
constexpr int kSmemAlign = 1024;       // the 128-byte swizzle repeats every 1024 bytes
constexpr int kSmemLimit = 232448;     // 227 KB, the most a block may ask for

// kGeluQ8 (int8 only): the exact GELU in f32 as kGelu, then quantised per
// row to int8 with one f32 scale per row (gemm_gelu_q8_kernel below).
enum Epilogue { kPlain = 0, kGelu = 1, kResidual = 2, kGeluQ8 = 3 };

__host__ __device__ constexpr int stage_bytes(int bn) { return (BM + bn) * kRowBytes; }

__host__ __device__ constexpr int smem_bytes(int bn, int stages) {
  return kSmemAlign + stages * stage_bytes(bn) + kEpiBytes + 2 * stages * 8;
}

struct GemmArgs {
  const bf16* bias;      // (N,) or null
  const bf16* res;       // (M, N) row stride ldr, epilogue kResidual only
  long long ldr;
  void* y;               // (M, N) row stride ldy: bf16, f32 after the int8 GELU, int8 after kGeluQ8
  long long ldy;
  float* ys;             // kGeluQ8 only: (M,) row scales of y
  const float* sx;       // int8 only: (M,) row scales
  const float* sw;       // int8 only: (N,) column scales
  int M, N, K;
  int epi;               // Epilogue
  int vec_y, vec_r;      // 16-byte stores of y / loads of res are aligned
  int tiles_m, tiles_n;
  int stages;
};

// ---- mbarrier, TMA and wgmma primitives -------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until the phase of ``bar`` with this parity has completed.  A wait of
// more than 10 s can only be a fault of the pipeline: trap, so the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint64_t t0 = 0;
  for (uint32_t i = 1;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if ((i & 0xFFFF) == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > 10000000000ull)
        asm volatile("trap;");
    }
  }
}

// Box (c0 = K element, c1 = row) of a 2-D tensor map into shared memory;
// completion counts its bytes on ``bar``.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Box (c0, c1, c2) of a 3-D tensor map, the same way.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Box (c0, c1, c2, c3) of a 4-D tensor map, the same way.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a K-major tile written by TMA with the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (the stride byte offset);
// the leading byte offset is unused in this layout.  The tile base is
// 1024-aligned; stepping along K within the row adds bytes >> 4 to the start
// address.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = (smem_u32(tile) >> 4) & 0x3FFF;
  return addr | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// wgmma descriptor of an MN-major tile (the B operand of a product whose N
// dimension is contiguous, read transposed): rows along K of 128 bytes (64
// N elements), written by TMA with the 128-byte swizzle, 8-row atoms 1024
// bytes apart along K (the stride byte offset); ``mn_stride`` bytes from one
// 64-element block of N to the next (the leading byte offset).  Stepping
// along K by 16 rows adds 2048 bytes to the start address.
__device__ __forceinline__ uint64_t sw128_desc_mn(const void* tile, uint32_t mn_stride) {
  const uint64_t addr = (smem_u32(tile) >> 4) & 0x3FFF;
  return addr | (uint64_t((mn_stride >> 4) & 0x3FFF) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads across a wgmma wait.
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(int& r) { asm volatile("" : "+r"(r)::"memory"); }

template <int BN>
__device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
  wgmma_bf16<BN>(d, da, db, scale_d);
}
template <int BN>
__device__ __forceinline__ void mma(int* d, uint64_t da, uint64_t db, int scale_d) {
  wgmma_s8<BN>(d, da, db, scale_d);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// ---- thread block clusters ---------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier, split: arrive (release: this thread's earlier shared
// memory writes become visible to the cluster's threads that pass the
// matching wait) and wait (acquire).  Not the .aligned forms, so that a warp
// may reach them diverged.  Every thread of every CTA of the cluster arrives
// and waits in turn, the same number of times.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The float at ``p`` in the shared memory of the cluster's CTA ``rank``
// (the same offset as ``p`` in this CTA's).
__device__ __forceinline__ float ld_cluster_f32(const float* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// The row amax of a quantising epilogue, from the partials at ``p`` in the
// shared memory of the cluster's ``n`` CTAs: the four lanes of a quad (which
// share a row of a wgmma or mma fragment) read every fourth CTA each and
// combine across the quad.  The whole warp calls it.
__device__ __forceinline__ float cluster_row_max(const float* p, int n, int lane) {
  float m = 0.f;
  for (int r = lane & 3; r < n; r += 4) m = fmaxf(m, ld_cluster_f32(p, r));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
}

// ---- epilogue ----------------------------------------------------------------

// The per-column vectors of a tile (bias; column scales for int8) and the
// per-row scales of this thread's two rows, loaded when the tile starts so
// that their latency hides behind the main loop; and the residual slab
// prefetched into L2 for the same reason.  Thread tid takes columns tid and
// tid + 128 of the tile.
template <int BN, bool kInt8>
struct TileVectors {
  static constexpr int kPer = (BN + 127) / 128;
  float bias[kPer], scale[kPer], row_scale[2];

  __device__ __forceinline__ void load(const GemmArgs& a, int m0, int n0, int tid) {
    const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + 128 * i, gc = n0 + c;
      const bool ok = c < BN && gc < a.N;
      bias[i] = ok && a.bias != nullptr ? __bfloat162float(a.bias[gc]) : 0.f;
      scale[i] = 0.f;
      if constexpr (kInt8) scale[i] = ok ? a.sw[gc] : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row_scale[h] = 0.f;
      if constexpr (kInt8) row_scale[h] = m0 + r0 + 8 * h < a.M ? a.sx[m0 + r0 + 8 * h] : 0.f;
    }
    if (a.epi == kResidual) {
      // 128-byte lines of the 64 x BN residual slab, BN / 64 per row.
      constexpr int kLines = BN / 64;
#pragma unroll
      for (int i = 0; i < (64 * kLines + 127) / 128; ++i) {
        const int l = tid + 128 * i;
        const int row = m0 + l / kLines, col = n0 + (l % kLines) * 64;
        if (l < 64 * kLines && row < a.M && col < a.N)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(a.res + (size_t)row * a.ldr + col));
      }
    }
  }

  __device__ __forceinline__ void store(float* vec, int tid) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (tid + 128 * i < BN) {
        vec[tid + 128 * i] = bias[i];
        vec[kMaxBN + tid + 128 * i] = scale[i];
      }
    }
  }
};

// One consumer warpgroup's 64 x BN slab (rows m0.., columns n0..) from its
// wgmma fragment to y: thread (warp w, lane l) holds rows 16w + l/4 (+8) and
// columns 8j + 2(l%4) (+1) of every 8-column group j.  The values go through
// the element-wise steps in registers, 128 bytes of each row (64 bf16 or 32
// f32 columns) at a time into ``stg``,
// then out as 16-byte row pieces, where the residual joins; each chunk's
// residual pieces are loaded before its staging, so the load overlaps it.
template <int BN, bool kGelu, typename Acc>
__device__ __forceinline__ void epilogue(const Acc* acc, const GemmArgs& a, int m0, int n0,
                                         uint8_t* stg,
                                         const TileVectors<BN, std::is_same<Acc, int>::value>& tv,
                                         int tid, int bar) {
  constexpr bool kInt8 = std::is_same<Acc, int>::value;
  constexpr bool kOutF32 = kInt8 && kGelu;   // the int8 GELU keeps its output in f32
  constexpr int kOut = kOutF32 ? 4 : 2;
  constexpr int kCols = 128 / kOut;           // a chunk: 128 bytes of each of the 64 rows
  float* vec = reinterpret_cast<float*>(stg + 64 * kEpiStride);
  tv.store(vec, tid);
  named_sync(bar);
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int ch = 0; ch < (BN + kCols - 1) / kCols; ++ch) {
    const int c0 = n0 + ch * kCols;
    if (c0 >= a.N || ch * kCols >= BN) continue;  // uniform over the warpgroup
    // 64 rows x 8 pieces of 16 bytes, four pieces per thread: piece i is row
    // i / 8, bytes (i % 8) * 16 of the chunk.
    uint4 res[4];
    if (!kGelu && a.epi == kResidual) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int i = tid + 128 * p;
        const int row = m0 + (i >> 3), col = c0 + (i & 7) * 8;
        const bf16* rp = a.res + (size_t)row * a.ldr + col;
        bf16* rv = reinterpret_cast<bf16*>(&res[p]);
        if (row < a.M && a.vec_r && col + 8 <= a.N) {
          res[p] = *reinterpret_cast<const uint4*>(rp);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            rv[e] = row < a.M && col + e < a.N ? rp[e] : __float2bfloat16(0.f);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kCols / 8; ++jj) {
      const int j = ch * (kCols / 8) + jj;
      if (j >= BN / 8) continue;
      const int c = jj * 8 + cq;
      // The pair's bias and column scales (columns tc, tc + 1 of the tile),
      // read once for both rows: the compiler would read them again after
      // each store below into the same shared memory.
      const int tc = ch * kCols + c;
      const float2 bias = *reinterpret_cast<const float2*>(vec + tc);
      const float2 cs = *reinterpret_cast<const float2*>(vec + kMaxBN + tc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (kInt8) {
            // The JAX package's dequantisation, each step rounded on its own.
            v[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), tv.row_scale[h]),
                             e ? cs.y : cs.x);
            if (a.bias != nullptr) v[e] = __fadd_rn(v[e], e ? bias.y : bias.x);
          } else {
            v[e] = acc[4 * j + 2 * h + e];
            if (a.bias != nullptr) v[e] += e ? bias.y : bias.x;
          }
          if constexpr (kGelu) v[e] = gelu(v[e]);
        }
        uint8_t* p = stg + (r0 + 8 * h) * kEpiStride + c * kOut;
        if constexpr (kOutF32)
          *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
        else
          *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v[0], v[1]);
      }
    }
    named_sync(bar);
    if constexpr (kOutF32) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int i = tid + 128 * p;
        const int r = i >> 3, row = m0 + r, col = c0 + (i & 7) * 4;
        if (row >= a.M || col >= a.N) continue;
        const float4 f = *reinterpret_cast<const float4*>(stg + r * kEpiStride + (i & 7) * 16);
        float* dst = static_cast<float*>(a.y) + (size_t)row * a.ldy + col;
        if (a.vec_y && col + 4 <= a.N) {
          *reinterpret_cast<float4*>(dst) = f;
        } else {
          const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < a.N) dst[e] = fv[e];
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int i = tid + 128 * p;
        const int r = i >> 3, row = m0 + r, col = c0 + (i & 7) * 8;
        if (row >= a.M || col >= a.N) continue;
        uint4 u = *reinterpret_cast<const uint4*>(stg + r * kEpiStride + (i & 7) * 16);
        bf16* o = reinterpret_cast<bf16*>(&u);
        if (!kGelu && a.epi == kResidual) {
          const bf16* rv = reinterpret_cast<const bf16*>(&res[p]);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[e] = __float2bfloat16(__bfloat162float(o[e]) + __bfloat162float(rv[e]));
        }
        bf16* dst = static_cast<bf16*>(a.y) + (size_t)row * a.ldy + col;
        if (a.vec_y && col + 8 <= a.N) {
          *reinterpret_cast<uint4*>(dst) = u;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (col + e < a.N) dst[e] = o[e];
        }
      }
    }
    named_sync(bar);
  }
}

// ---- the kernel --------------------------------------------------------------

template <typename Acc, int BN, bool kGelu>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tma_x,
                const __grid_constant__ CUtensorMap tma_w, const GemmArgs a) {
  constexpr int kStage = stage_bytes(BN);
  constexpr int kBK = std::is_same<Acc, int>::value ? kRowBytes : kRowBytes / 2;  // elements
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) & ~uintptr_t(kSmemAlign - 1));
  const int S = a.stages;
  uint8_t* epi_smem = smem + S * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi_smem + kEpiBytes);
  uint64_t* empty = full + S;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the TMA bytes
      mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int KT = (a.K + kBK - 1) / kBK;
  const int tiles = a.tiles_m * a.tiles_n;
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {
    // Producer: one thread keeps the ring full, across tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tma_x)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tma_w)) : "memory");
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % a.tiles_m) * BM, n0 = (t / a.tiles_m) * BN;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[s], ph ^ 1);
          uint8_t* st = smem + s * kStage;
          mbar_expect_tx(&full[s], kStage);
          tma_load_2d(st, &tma_x, &full[s], kt * kBK, m0);
          tma_load_2d(st + BM * kRowBytes, &tma_w, &full[s], kt * kBK, n0);
          if (++s == S) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of every tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x & 127;
    uint8_t* stg = epi_smem + cw * kEpiWgBytes;
    Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % a.tiles_m) * BM, n0 = (t / a.tiles_m) * BN;
      TileVectors<BN, std::is_same<Acc, int>::value> tv;
      tv.load(a, m0 + cw * 64, n0, tid);
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(&full[s], ph);
        const uint8_t* st = smem + s * kStage;
        const uint64_t da = sw128_desc(st + cw * 64 * kRowBytes);
        const uint64_t db = sw128_desc(st + BM * kRowBytes);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) mma<BN>(acc, da + 2 * k, db + 2 * k, (kt | k) != 0);
        wgmma_commit();
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
        // The previous stage's products are done once at most this group is
        // in flight: hand that stage back to the producer.
        wgmma_wait<1>();
        if (kt > 0 && tid == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
      if (tid == 0) mbar_arrive(&empty[prev]);
      epilogue<BN, kGelu>(acc, a, m0 + cw * 64, n0, stg, tv, tid, 1 + cw);
    }
  }
}

// ---- the quantising GELU product (kGeluQ8) -------------------------------------
//
// h8, hs = quant_rows(gelu(x8 . w8^T * s_row * s_col + b)): the FFN's first
// int8 product with _quant_act (mixermdm_tpu/ops/fused_block.py:58) of its
// f32 hidden fused into the epilogue, so the hidden never reaches device
// memory (M x N x 4 bytes written and read back by quant_rows before).  A
// row's scale needs the max |h| over all N columns, which span N / BN tiles:
// a thread block cluster of those tiles (at most 16 CTAs) computes one row
// block together.  Each CTA publishes its 64 NC rows' partial maxima in its
// shared memory, the cluster barrier (release / acquire) orders them, and
// every CTA reads the other CTAs' partials through distributed shared memory
// (mapa + ld.shared::cluster): no second launch, no device-memory round trip.
//
// The walk: cluster c takes row blocks c, c + clusters, ...; CTA rank r of a
// cluster keeps columns r BN .. r BN + BN - 1, so the walk is the same for
// every CTA of a cluster and their cluster barriers pair up.  The partials
// are double-buffered by tile parity: a CTA writes buffer k & 1 of tile k only
// after the barrier of tile k - 1, which every peer reaches after reading
// buffer (k - 2) & 1.  The producer warpgroup arrives at each tile's barrier
// once it has issued that tile's loads, and waits for it after issuing the
// next tile's, so the loads of tile k + 1 still overlap the epilogue of tile
// k.  A last barrier keeps every CTA resident until its peers have read its
// last partials.
//
// The GELU values are kGelu's, computed by the same expressions, and the
// quantisation is quant_rows' (IEEE division, rintf), so h8 and hs are bit
// for bit quant_rows of the kGelu product's f32 output.  Columns past N
// (zero-filled operands, whose gelu(b) is not zero) stay out of the max.
//
// NC (1-3) consumer warpgroups of 64 rows each (BM = 64 NC); the host plans
// NC, the stages and the number of clusters (ops/linear_q8.py: gelu_q8_plan,
// from cudaOccupancyMaxActiveClusters).  The tile is 128 columns wide
// (kGeluQ8BN): with 256, and 128 accumulators a thread, this epilogue and
// kGelu's ran several times slower per tile on an H100 with no register
// spilled, so N = 2048 takes a cluster of 16 CTAs (the non-portable size),
// and three consumer warpgroups keep 12 warps per SM on the epilogue's
// chains of dependent operations (chip_smoke.py times each NC).

__host__ __device__ constexpr int gelu_q8_stage_bytes(int nc, int bn) {
  return (64 * nc + bn) * kRowBytes;
}

// Dynamic shared memory: the alignment slack, the ring, per consumer
// warpgroup the epilogue staging and two buffers of 64 row partials, and the
// full / empty mbarrier pairs.
__host__ __device__ constexpr int gelu_q8_smem_bytes(int nc, int bn, int stages) {
  return kSmemAlign + stages * gelu_q8_stage_bytes(nc, bn) + nc * (kEpiWgBytes + 2 * 64 * 4) +
         2 * stages * 8;
}

constexpr int kMaxClusterCtas = 16;  // 8 portable; 16 with the non-portable attribute
constexpr int kGeluQ8BN = 128;       // the tile width the host launches

// One consumer warpgroup's 64 x BN slab: GELU in registers, the rows'
// partial maxima to ``part`` (this warpgroup's 64 floats of the tile's
// buffer), the cluster exchange, then int8 through ``stg`` as 16-byte row
// pieces (128 columns of each row per chunk) and the row scales from rank 0.
template <int BN>
__device__ __forceinline__ void epilogue_gelu_q8(int* acc, const GemmArgs& a, int m0, int n0,
                                                 uint8_t* stg, const TileVectors<BN, true>& tv,
                                                 float* part, int tid, int bar) {
  float* vec = reinterpret_cast<float*>(stg + 64 * kEpiStride);
  tv.store(vec, tid);
  named_sync(bar);
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  float amax[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int tc = j * 8 + cq;
    const float2 bias = *reinterpret_cast<const float2*>(vec + tc);
    const float2 cs = *reinterpret_cast<const float2*>(vec + kMaxBN + tc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // kGelu's arithmetic (epilogue above), expression for expression.
        float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), tv.row_scale[h]),
                            e ? cs.y : cs.x);
        if (a.bias != nullptr) v = __fadd_rn(v, e ? bias.y : bias.x);
        v = gelu(v);
        if (n0 + tc + e >= a.N) v = 0.f;
        acc[4 * j + 2 * h + e] = __float_as_int(v);
        amax[h] = fmaxf(amax[h], fabsf(v));
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 1));
    amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 2));
  }
  if ((lane & 3) == 0) {
    part[r0] = amax[0];
    part[r0 + 8] = amax[1];
  }
  cluster_arrive();
  cluster_wait();
  float s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    s[h] = fmaxf(cluster_row_max(part + r0 + 8 * h, a.tiles_n, lane), 1e-8f) / 127.f;
  if (cluster_rank() == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (m0 + r0 + 8 * h < a.M) a.ys[m0 + r0 + 8 * h] = s[h];
  }
#pragma unroll
  for (int ch = 0; ch < (BN + 127) / 128; ++ch) {
    const int c0 = n0 + ch * 128;
    const int cols = BN - ch * 128 < 128 ? BN - ch * 128 : 128;  // of this tile in the chunk
    if (c0 >= a.N) continue;  // uniform over the warpgroup
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = ch * 16 + jj;
      if (j >= BN / 8) continue;  // a constant bound, so that acc stays in registers
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t w = q8(__int_as_float(acc[4 * j + 2 * h]), s[h]) |
                           (q8(__int_as_float(acc[4 * j + 2 * h + 1]), s[h]) << 8);
        *reinterpret_cast<uint16_t*>(stg + (r0 + 8 * h) * kEpiStride + jj * 8 + cq) =
            static_cast<uint16_t>(w);
      }
    }
    named_sync(bar);
    // 64 rows x 8 pieces of 16 bytes, four pieces per thread: piece i is row
    // i / 8, columns (i % 8) * 16 of the chunk.
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = tid + 128 * p;
      const int r = i >> 3, row = m0 + r, c = (i & 7) * 16, col = c0 + c;
      if (row >= a.M || c >= cols || col >= a.N) continue;
      const uint4 u = *reinterpret_cast<const uint4*>(stg + r * kEpiStride + c);
      int8_t* dst = static_cast<int8_t*>(a.y) + (size_t)row * a.ldy + col;
      if (a.vec_y && col + 16 <= a.N) {
        *reinterpret_cast<uint4*>(dst) = u;
      } else {
        const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (col + e < a.N) dst[e] = b[e];
      }
    }
    named_sync(bar);
  }
}

template <int BN, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    gemm_gelu_q8_kernel(const __grid_constant__ CUtensorMap tma_x,
                        const __grid_constant__ CUtensorMap tma_w, const GemmArgs a) {
  constexpr int kBM = 64 * NC;
  constexpr int kStage = gelu_q8_stage_bytes(NC, BN);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) & ~uintptr_t(kSmemAlign - 1));
  const int S = a.stages;
  uint8_t* epi_smem = smem + S * kStage;
  float* parts = reinterpret_cast<float*>(epi_smem + NC * kEpiWgBytes);  // [2][kBM]
  uint64_t* full = reinterpret_cast<uint64_t*>(parts + 2 * kBM);
  uint64_t* empty = full + S;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);    // the producer's arrive, plus the TMA bytes
      mbar_init(&empty[s], NC);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int KT = (a.K + kRowBytes - 1) / kRowBytes;
  const int cn = a.tiles_n;  // CTAs per cluster: the N-tiles of one row block
  const int cluster = blockIdx.x / cn, clusters = gridDim.x / cn;
  const int n0 = static_cast<int>(cluster_rank()) * BN;
  const int wg = threadIdx.x >> 7;

  // Registers: the producer warpgroup gives its own to the consumers; with
  // three consumer warpgroups 128 x 24 + 384 x 160 fill the SM's 64K.
  constexpr int kProducerRegs = NC == 3 ? 24 : 40;
  constexpr int kConsumerRegs = NC == 3 ? 160 : 232;
  if (wg == 0) {
    // Producer warpgroup: thread 0 keeps the ring full; all 128 threads take
    // their part in each tile's cluster barrier.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    int s = 0, k = 0;
    uint32_t ph = 0;
    for (int mb = cluster; mb < a.tiles_m; mb += clusters, ++k) {
      if (threadIdx.x == 0) {
        if (k == 0) {
          asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tma_x)) : "memory");
          asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tma_w)) : "memory");
        }
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[s], ph ^ 1);
          uint8_t* st = smem + s * kStage;
          mbar_expect_tx(&full[s], kStage);
          tma_load_2d(st, &tma_x, &full[s], kt * kRowBytes, mb * kBM);
          tma_load_2d(st + kBM * kRowBytes, &tma_w, &full[s], kt * kRowBytes, n0);
          if (++s == S) {
            s = 0;
            ph ^= 1;
          }
        }
      }
      if (k > 0) cluster_wait();  // the barrier of tile k - 1
      cluster_arrive_relaxed();   // tile k's
    }
    if (k > 0) cluster_wait();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int tid = threadIdx.x & 127;
    uint8_t* stg = epi_smem + cw * kEpiWgBytes;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int s = 0, k = 0;
    uint32_t ph = 0;
    for (int mb = cluster; mb < a.tiles_m; mb += clusters, ++k) {
      const int m0 = mb * kBM;
      TileVectors<BN, true> tv;
      tv.load(a, m0 + cw * 64, n0, tid);
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(&full[s], ph);
        const uint8_t* st = smem + s * kStage;
        const uint64_t da = sw128_desc(st + cw * 64 * kRowBytes);
        const uint64_t db = sw128_desc(st + kBM * kRowBytes);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma<BN>(acc, da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
        wgmma_commit();
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
        wgmma_wait<1>();
        if (kt > 0 && tid == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
      if (tid == 0) mbar_arrive(&empty[prev]);
      epilogue_gelu_q8<BN>(acc, a, m0 + cw * 64, n0, stg, tv, parts + (k & 1) * kBM + cw * 64,
                           tid, 1 + cw);
    }
  }
  // No CTA leaves while a peer may still read its partials.
  cluster_arrive();
  cluster_wait();
}

// ---- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                                                : nullptr;
  }();
  return fn;
}

constexpr int kMaxMapRank = 4;

struct MapKey {
  const void* ptr;
  cuuint64_t dims[kMaxMapRank], strides[kMaxMapRank - 1];
  cuuint32_t box[kMaxMapRank];
  int rank, dtype;
  bool operator==(const MapKey& o) const {
    if (ptr != o.ptr || rank != o.rank || dtype != o.dtype) return false;
    for (int i = 0; i < kMaxMapRank; ++i)
      if (dims[i] != o.dims[i] || box[i] != o.box[i] ||
          (i < kMaxMapRank - 1 && strides[i] != o.strides[i]))
        return false;
    return true;
  }
};

// The tensor map of a rank-2 to rank-4 tensor (dims innermost first, byte
// strides of dims 1.., boxes of ``box``), 128-byte swizzle, zero fill out of
// bounds.  Encoding is host arithmetic; the last 64 maps are kept, keyed on
// every field that enters the map (the caching allocator hands the same
// pointer to tensors of other shapes).  False if the driver refuses.
inline bool tensor_map(CUtensorMap* out, CUtensorMapDataType dtype, const void* ptr, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  constexpr int kSlots = 64;
  static std::mutex mu;
  static MapKey keys[kSlots];
  static CUtensorMap maps[kSlots];
  static int used = 0, next = 0;
  if (rank < 2 || rank > kMaxMapRank) return false;
  MapKey key{ptr, {}, {}, {}, rank, static_cast<int>(dtype)};
  for (int i = 0; i < kMaxMapRank; ++i) {
    key.dims[i] = i < rank ? dims[i] : 1;
    key.box[i] = i < rank ? box[i] : 1;
    if (i < kMaxMapRank - 1) key.strides[i] = i < rank - 1 ? strides[i] : 0;
  }
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (keys[i] == key) {
      *out = maps[i];
      return true;
    }
  }
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem_strides[kMaxMapRank] = {1, 1, 1, 1};
  if (encode(out, dtype, rank, const_cast<void*>(ptr), key.dims, key.strides, key.box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  const int slot = used < kSlots ? used++ : next;
  next = (slot + 1) % kSlots;
  keys[slot] = key;
  maps[slot] = *out;
  return true;
}

// A K-contiguous (outer, inner) matrix with row stride ld_bytes, in boxes of
// (box_outer, box_inner).
inline bool tensor_map_2d(CUtensorMap* out, CUtensorMapDataType dtype, const void* ptr,
                          unsigned long long inner, unsigned long long outer,
                          unsigned long long ld_bytes, unsigned box_inner, unsigned box_outer) {
  const cuuint64_t dims[2] = {inner, outer}, strides[1] = {ld_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  return tensor_map(out, dtype, ptr, 2, dims, strides, box);
}

template <typename Acc, int BN>
int launch_bn(const CUtensorMap& tx, const CUtensorMap& tw, const GemmArgs& a, int grid, int smem,
              cudaStream_t stream) {
  if (a.stages < 2 || smem < smem_bytes(BN, a.stages) || smem > kSmemLimit || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.epi == kGelu)
    gemm_kernel<Acc, BN, true><<<grid, kThreads, smem, stream>>>(tx, tw, a);
  else
    gemm_kernel<Acc, BN, false><<<grid, kThreads, smem, stream>>>(tx, tw, a);
  return static_cast<int>(cudaGetLastError());
}

// Encode both maps (box BM rows of x, BN rows of w, 128 bytes deep) and
// launch the instantiation for ``bn``.
template <typename Acc>
int launch(CUtensorMapDataType dtype, int elem_bytes, const void* x, long long ldx, const void* w,
           long long ldw, const GemmArgs& a, int bn, int grid, int smem, cudaStream_t stream) {
  const unsigned bk = kRowBytes / elem_bytes;
  CUtensorMap tx, tw;
  if (!tensor_map_2d(&tx, dtype, x, a.K, a.M, ldx * elem_bytes, bk, BM) ||
      !tensor_map_2d(&tw, dtype, w, a.K, a.N, ldw * elem_bytes, bk, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bn) {
    case 64: return launch_bn<Acc, 64>(tx, tw, a, grid, smem, stream);
    case 128: return launch_bn<Acc, 128>(tx, tw, a, grid, smem, stream);
    case 192: return launch_bn<Acc, 192>(tx, tw, a, grid, smem, stream);
    case 256: return launch_bn<Acc, 256>(tx, tw, a, grid, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Allow every instantiation the full 227 KB of dynamic shared memory.  Once,
// when the library loads: never inside a launch that a graph may capture.
template <typename Acc, int BN>
cudaError_t set_smem_limit() {
  cudaError_t e = cudaFuncSetAttribute(gemm_kernel<Acc, BN, false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  return e != cudaSuccess ? e
                          : cudaFuncSetAttribute(gemm_kernel<Acc, BN, true>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kSmemLimit);
}

template <typename Acc>
int set_smem_limits() {
  cudaError_t e = set_smem_limit<Acc, 64>();
  if (e == cudaSuccess) e = set_smem_limit<Acc, 128>();
  if (e == cudaSuccess) e = set_smem_limit<Acc, 192>();
  if (e == cudaSuccess) e = set_smem_limit<Acc, 256>();
  return static_cast<int>(e);
}

// Whether 16-byte accesses at row starts are aligned for a matrix of this
// base, row stride (elements) and element size.
inline int rows_aligned16(const void* p, long long ld, int elem_bytes) {
  return p != nullptr && aligned16(p) && (ld * elem_bytes) % 16 == 0;
}

}  // namespace sm90
}  // namespace mm
