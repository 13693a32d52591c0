// attention: softmax(Q K^T / sqrt(D) + key_bias + attn_mask) V with torch's
// add_zero_attn done algebraically; f32 softmax state.
//
// Replaces mixermdm_tpu/ops/attention.py:_attn_body (_attn_kernel,
// _attn_kernel_qk) and the per-head attention loop inside the Pallas block
// kernels (_sa_block_kernel, _ca_block_kernel).  The TPU kernel holds the
// whole T x T logit matrix in VMEM; here no logit reaches device memory.
//
// Zero-attn: the implicit zero key has logit 0 and value 0, so starting the
// running state at (max = 0, sum = 1, acc = 0) instead of (-inf, 0, 0) adds
// exactly exp(0 - max) to the denominator and nothing to the numerator.  Keys
// past Tk get -inf (excluded); masked keys get the caller's -1e30 bias, so a
// fully masked row stays finite exactly as in the reference.
//
// Row statistics: given a ``stats`` buffer (2, B, H, Tq), each row's max
// (zero key included; 0 for a row with no finite logit) and its denominator
// (1 for a row with none) are written beside the output, for the backward
// (csrc/attention_bwd.cu) to read instead of recomputing them.  Kept as two
// values, not one log-sum-exp: for a fully masked row without the zero key
// the max is about -1e30 and max + log(sum) rounds back to -1e30, which
// would turn p = 1/Tk into p = 1.
//
// bf16 inputs (attention_kernel): what bounds it at the denoiser shape
// (8, 8, 299, 128) is the read of K and V into the SMs (every query tile of
// a head reads all of them again, from L2) and the latency of a short loop;
// the operations are 2.9 GFLOP, 3 us of tensor-core time.  The design:
//
// - Loads.  TMA copies 64-row boxes of Q, K and V, 128 bytes deep (64
//   elements), with the 128-byte swizzle, straight out of the strided
//   (B, H, T, D) views (the fused blocks pass slices of the packed QKV
//   projection) through rank-4 tensor maps.  D = 128 is two such slabs;
//   D = 96 reads a second slab half past the row end, which TMA zero-fills,
//   and runs as D = 128.  Rows past T are zero-filled too.
// - Pipeline.  A ring of up to 3 K/V stages on full / empty mbarrier pairs;
//   a producer warp refills a stage as soon as every warpgroup has released
//   it, so the next tiles are in flight while the current one is multiplied
//   and the warpgroups never wait for each other (one's softmax runs beside
//   another's products).
// - Products.  Each consumer warpgroup owns 64 query rows: S = Q K^T is a
//   wgmma m64n64k16 with both operands in shared memory (K-major); O += P V
//   is a wgmma m64nDk16 with P from registers (the accumulator of S, packed
//   to bf16 in place) and V read transposed (MN-major).
// - Grid.  1-3 warpgroups per block (host plan, ops/attention.py:
//   attention_plan): at T = 299, 3 warpgroups of 64 rows make 2 query tiles
//   per head, 128 blocks on 132 SMs in one wave, and each K/V tile read into
//   an SM serves 192 query rows.
//
// The output is bf16 or f32, or (attention_q8, the W8A8 blocks) int8 with
// one f32 scale per row of the (B, Tq, H D) output matrix: _quant_act
// (mixermdm_tpu/ops/fused_block.py:58) of the self-attention block's f32
// output (:140-146, heads concatenated before any cast) or of the
// cross-attention block's bf16 output, fused into this kernel's epilogue so
// the unquantised output never reaches device memory.  A row's scale needs
// its max |value| over all H heads, one CTA each: the H CTAs of a query
// tile run as one thread block cluster (dims (1, H, 1)).  Each CTA
// publishes its rows' partial maxima in shared memory, the cluster barrier
// (release / acquire) orders them, every CTA reads the others' through
// distributed shared memory (mapa + ld.shared::cluster), quantises with
// quant_rows' arithmetic (IEEE division, rintf) and writes int8; rank 0
// writes the scales; a second barrier keeps each CTA resident until its
// peers have read it.  The values are the unfused output's (o / l in f32,
// rounded to bf16 for the CA form), so int8 and scales are bit for bit
// quant_rows of that output.  What it costs: clusters of 8 CTAs of one SM
// each fit 15 at a time on an H100 SXM (the GPCs' multiples of 8 SMs, 120
// SMs), so at (8, 8, 299) the 16 query-tile clusters of the unfused plan
// take two waves; the host plans the warpgroups per block for waves of
// clusters (ops/attention.py: attention_q8_plan).
//
// f32 inputs (attention_f32_kernel; the f32 softmax branch of _attn_body,
// attention.py:60; on the port's paths the CLIP post-encoders, (B, 8, 77,
// 96)): f32 in, f32 out, every product an f32 FMA on the CUDA cores (no
// TF32: one pass keeps ~10 bits and could not meet the 1e-5 agreement the
// f32 path is held to; a three-pass TF32 split on the tensor cores was
// slower at the head shape, where the grid is small and each block's chain
// of products is the time).  At T = 77 one head's K and V (2 x 77 x 96 x
// 4 B = 59 KB) fit in shared memory: a block of 8 warps loads them once with
// 16-byte cp.async and each warp owns one query row, so the softmax needs no
// online rescaling and the grid (ceil(Tq / 8) x H x B = 160 blocks at the
// head shape) fills the card.  Longer rows go through 128-key chunks with
// the online softmax.  What bounds it is shared memory: each lane reads its
// own key rows, a 16-byte read per four FMAs.
#include "gemm_sm90.cuh"

using mm::bf16;

namespace {

namespace sm90 = mm::sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;  // the reference's bias of a masked key

// 2^x, one MUFU instruction (relative error ~2^-22; results below 2^-126
// flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// bf16 inputs: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int kRows = 64;                // query rows per warpgroup; keys per K/V tile
constexpr int kSlabBytes = kRows * 128;  // 64 rows x 128 bytes, one swizzled slab
constexpr int kMaxWarpgroups = 3;
constexpr int kMaxStages = 3;
constexpr int kMaxClusterHeads = 8;  // the portable cluster size: one CTA per head

// Dynamic shared memory of one block: the Q slabs of every warpgroup, the
// K/V ring, one barrier for Q and a full / empty pair per stage, aligned to
// the swizzle's 1024-byte period.  ops/attention.py:attention_smem_bytes is the same
// formula.
__host__ __device__ constexpr int fwd_smem_bytes(int dp, int nwg, int stages) {
  return sm90::kSmemAlign + (nwg + 2 * stages) * (dp / 64) * kSlabBytes + 8 * (1 + 2 * stages);
}

// What the bf16-input kernel writes: the output in bf16 or f32, or (the
// quantising epilogue of attention_q8) the output quantised per row of the
// (B, Tq, H D) matrix, from the f32 values or from their bf16 rounding.
enum OutKind { kOutBf16 = 0, kOutF32 = 1, kOutQ8F32 = 2, kOutQ8Bf16 = 3 };

struct FwdParams {
  void* o;  // bf16, f32, or int8 for the quantising instantiations
  long long o_sb, o_sh, o_st;
  float* qscale;       // (B, Tq) row scales of the int8 output, or null
  float* stats;        // (2, B, H, Tq) row max and denominator, or null
  const bool* kpm;     // (B, Tk), true = masked (bias -1e30), or null
  const float* amask;  // (Tq, Tk) additive, or null
  int B, H, Tq, Tk, D, zero_attn, stages;
  float scale;
  int pos[3][3];  // per map (q, k, v): the coordinate slot (1..3) of t, h and b
};

// The two cluster barriers of the quantising epilogue, for a thread that
// publishes and reads nothing (the producer warp, a warpgroup past Tq).
__device__ __forceinline__ void cluster_pass() {
  sm90::cluster_arrive_relaxed();
  sm90::cluster_wait();
  sm90::cluster_arrive_relaxed();
  sm90::cluster_wait();
}

// Box (64 columns from c, 64 rows from t) of one (b, h) of a view map whose
// coordinate slots of t, h and b are pos[0..2].
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         const int (&pos)[3], int c, int t, int h, int b) {
  const auto at = [&](int slot) { return pos[0] == slot ? t : pos[1] == slot ? h : b; };
  sm90::tma_load_4d(dst, map, bar, c, at(1), at(2), at(3));
}

template <int DP, int NWG, int OUT>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
    attention_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ FwdParams p) {
  constexpr int kSlabs = DP / 64;
  constexpr int kTileBytes = kSlabs * kSlabBytes;  // 64 rows of Q, K or V
  constexpr int NT = DP / 8;                       // n8 column groups of the output
  constexpr bool kQ8 = OUT == kOutQ8F32 || OUT == kOutQ8Bf16;
  // The quantising epilogue's per-row partial maxima, read by the cluster.
  __shared__ float row_amax[kQ8 ? kRows * NWG : 1];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + sm90::kSmemAlign - 1) &
      ~uintptr_t(sm90::kSmemAlign - 1));
  const int S = p.stages;
  uint8_t* sQ = smem;                         // slab s of warpgroup w: (s * NWG + w) slabs in
  uint8_t* sKV = smem + NWG * kTileBytes;     // stage st: K at 2 st tiles, V at 2 st + 1
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sKV + 2 * S * kTileBytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + S;

  const int q0 = blockIdx.x * kRows * NWG, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int nkv = (p.Tk + kRows - 1) / kRows;
  const int nwg_rows = min(NWG, (p.Tq - q0 + kRows - 1) / kRows);  // warpgroups with rows

  auto issue_kv = [&](int j) {
    const int st = j % S;
    uint8_t* dk = sKV + 2 * st * kTileBytes;
    sm90::mbar_expect_tx(&full[st], 2 * kTileBytes);
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) {
      load_box(dk + s * kSlabBytes, &map_k, &full[st], p.pos[1], 64 * s, j * kRows, h, b);
      load_box(dk + kTileBytes + s * kSlabBytes, &map_v, &full[st], p.pos[2], 64 * s, j * kRows,
               h, b);
    }
  };

  if (tid == 0) {
    sm90::mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);          // the producer's arrive, plus the TMA bytes
      sm90::mbar_init(&empty[s], nwg_rows);  // one arrive per warpgroup with rows
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == NWG) {
    // Producer warp: Q, then the K/V ring, each stage refilled once every
    // warpgroup has released it.  The warpgroups never wait for each other.
    if (tid == 128 * NWG) {
      sm90::mbar_expect_tx(qbar, nwg_rows * kTileBytes);
      for (int w = 0; w < nwg_rows; ++w)
#pragma unroll
        for (int s = 0; s < kSlabs; ++s)
          load_box(sQ + (s * NWG + w) * kSlabBytes, &map_q, qbar, p.pos[0], 64 * s,
                   q0 + w * kRows, h, b);
      for (int j = 0; j < nkv; ++j) {
        if (j >= S) sm90::mbar_wait(&empty[j % S], ((j / S) + 1) & 1);
        issue_kv(j);
      }
    }
    if constexpr (kQ8) cluster_pass();
    return;
  }
  if (wg >= nwg_rows) {  // a warpgroup whose rows are all past Tq
    if constexpr (kQ8) cluster_pass();
    return;
  }
  const int r_lo = q0 + wg * kRows + warp * 16 + (lane >> 2);  // rows r_lo and r_lo + 8

  // Running state for this thread's two rows.  The row sum is kept per
  // thread (one quarter of the columns) and reduced at the end, so the zero
  // key's 1 is credited to one lane of the four.
  float m[2], l[2];
  const float l0 = (p.zero_attn && (lane & 3) == 0) ? 1.f : 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = p.zero_attn ? 0.f : -INFINITY;
    l[i] = l0;
  }
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  sm90::mbar_wait(qbar, 0);
  for (int j = 0; j < nkv; ++j) {
    const int st = j % S, k0 = j * kRows;
    {
      sm90::mbar_wait(&full[st], (j / S) & 1);
      const uint8_t* sK = sKV + 2 * st * kTileBytes;
      const uint8_t* sV = sK + kTileBytes;

      // S = Q K^T: 64 rows x 64 keys per warpgroup, K-major operands.
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int slab = kk / 4, step = kk % 4;
        sm90::wgmma_bf16<64>(s, sm90::sw128_desc(sQ + (slab * NWG + wg) * kSlabBytes) + 2 * step,
                             sm90::sw128_desc(sK + slab * kSlabBytes) + 2 * step, kk != 0);
      }
      sm90::wgmma_commit();

      // While it runs: the bias of this thread's 16 keys k0 + 8t +
      // 2(lane % 4) + c (-inf past Tk, -1e30 where masked), loads clamped to
      // the row so that none is conditional.
      float cb[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = k0 + (c >> 1) * 8 + (lane & 3) * 2 + (c & 1);
        float v = col < p.Tk ? 0.f : -INFINITY;
        if (p.kpm != nullptr && p.kpm[(size_t)b * p.Tk + min(col, p.Tk - 1)]) v += kMasked;
        cb[c] = v;
      }
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) sm90::reg_fence(s[i]);

      // Scale, bias (fmaf(s, scale, b) rounds as s * scale + b does for
      // b in {0, -1e30, -inf}), mask, running max; thread holds s[4t + e]
      // at row r_lo + 8 (e >> 1), key k0 + 8t + 2(lane % 4) + (e & 1).
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = fmaf(s[i], p.scale, cb[2 * (i >> 2) + (i & 1)]);
      if (p.amask != nullptr) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = min(r_lo + ((i >> 1) & 1) * 8, p.Tq - 1);
          const int col = min(k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1), p.Tk - 1);
          s[i] += p.amask[(size_t)row * p.Tk + col];
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float mref[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mnew = fmaxf(m[i], mx[i]);
        mref[i] = mnew == -INFINITY ? 0.f : mnew;  // a row with no finite logit yet
        alpha[i] = ex2((m[i] - mref[i]) * kLog2e);
        m[i] = mnew;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        o[4 * t + 0] *= alpha[0];
        o[4 * t + 1] *= alpha[0];
        o[4 * t + 2] *= alpha[1];
        o[4 * t + 3] *= alpha[1];
      }

      // P = exp(S - max), packed to bf16 A fragments: k-step kk covers keys
      // 16kk..16kk+15, the accumulator's n8 groups 2kk and 2kk + 1.
      uint32_t pf[4][4];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pv[e] = ex2((s[4 * t + e] - mref[e >> 1]) * kLog2e);
          l[e >> 1] += pv[e];
        }
        pf[t >> 1][(t & 1) * 2 + 0] = mm::pack_bf16x2(pv[0], pv[1]);
        pf[t >> 1][(t & 1) * 2 + 1] = mm::pack_bf16x2(pv[2], pv[3]);
      }

      // O += P V: V [key][d] is N-major; 16 keys per k-step, 2048 bytes.
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) sm90::reg_fence(o[i]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_bf16_rs<DP>(o, pf[kk], sm90::sw128_desc_mn(sV + kk * 2048, kSlabBytes));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) sm90::reg_fence(o[i]);
    }
    if ((tid & 127) == 0) sm90::mbar_arrive(&empty[st]);  // stage st is free
  }

  const size_t n = (size_t)p.B * p.H * p.Tq, bh = (size_t)b * p.H + h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = r_lo + i * 8;
    if (p.stats != nullptr && (lane & 3) == 0 && row < p.Tq) {
      p.stats[bh * p.Tq + row] = m[i] == -INFINITY ? 0.f : m[i];
      p.stats[n + bh * p.Tq + row] = l[i] > 0.f ? l[i] : 1.f;
    }
    l[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  if constexpr (kQ8) {
    // The output row, H D values, is spread over the H CTAs of this cluster
    // (one head each).  Each thread forms its values as the unquantised
    // output would hold them (f32, or rounded to bf16), takes their |max|
    // over the row's D columns of this head (the quad of lanes that shares
    // the row, shfl 1 and 2), publishes it, and after the cluster barrier
    // reads the other heads' partials through distributed shared memory.
    float amax[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < DP / 4; ++e) {
        float v = o[4 * (e >> 1) + 2 * i + (e & 1)] * l[i];
        if constexpr (OUT == kOutQ8Bf16) v = __bfloat162float(__float2bfloat16_rn(v));
        o[4 * (e >> 1) + 2 * i + (e & 1)] = v;
        amax[i] = fmaxf(amax[i], fabsf(v));
      }
      amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 1));
      amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 2));
    }
    const int lr = wg * kRows + warp * 16 + (lane >> 2);  // this CTA's row of r_lo
    if ((lane & 3) == 0) {
      row_amax[lr] = amax[0];
      row_amax[lr + 8] = amax[1];
    }
    sm90::cluster_arrive();
    sm90::cluster_wait();
#pragma unroll
    for (int i = 0; i < 2; ++i) amax[i] = sm90::cluster_row_max(&row_amax[lr + 8 * i], p.H, lane);
    sm90::cluster_arrive_relaxed();  // done with the peers' partials
    const bool rank0 = sm90::cluster_rank() == 0;
    int8_t* o8 = static_cast<int8_t*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r_lo + i * 8;
      if (row >= p.Tq) continue;
      const float sc = fmaxf(amax[i], 1e-8f) / 127.f;  // quant_rows' scale, IEEE division
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const uint32_t w = mm::q8(o[4 * t + 2 * i], sc) | (mm::q8(o[4 * t + 2 * i + 1], sc) << 8);
        *reinterpret_cast<uint16_t*>(o8 + row * p.o_st + t * 8 + (lane & 3) * 2) =
            static_cast<uint16_t>(w);
      }
      if (rank0 && (lane & 3) == 0) p.qscale[(size_t)b * p.Tq + row] = sc;
    }
    sm90::cluster_wait();  // no CTA leaves while a peer may still read its partials
    return;
  }
  const long long o_off = b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + i * 8;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int col = t * 8 + (lane & 3) * 2;
      if (col >= p.D) continue;
      const long long off = o_off + (size_t)row * p.o_st + col;
      const float v0 = o[4 * t + 2 * i] * l[i], v1 = o[4 * t + 2 * i + 1] * l[i];
      if (OUT == kOutF32)
        *reinterpret_cast<float2*>(static_cast<float*>(p.o) + off) = make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.o) + off) = mm::pack_bf16x2(v0, v1);
    }
  }
}

// The tensor map of a strided (B, H, T, D) bf16 view (strides in elements,
// unit stride along D): D innermost, then T, H and B in the order of their
// strides (the packed QKV projection has H inside T); boxes of 64 columns
// by 64 rows of T.  pos receives the slot of t, h and b.
bool view_map(CUtensorMap* map, const void* ptr, const long long* strides, int B, int H, int T,
              int D, int* pos) {
  struct Dim {
    cuuint64_t size, stride;
    int which;  // 0 t, 1 h, 2 b
  } d[3] = {{static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(strides[2]) * 2, 0},
            {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(strides[1]) * 2, 1},
            {static_cast<cuuint64_t>(B), static_cast<cuuint64_t>(strides[0]) * 2, 2}};
  for (int i = 1; i < 3; ++i)
    for (int k = i; k > 0 && d[k].stride < d[k - 1].stride; --k) {
      const Dim t = d[k];
      d[k] = d[k - 1];
      d[k - 1] = t;
    }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), d[0].size, d[1].size, d[2].size};
  const cuuint64_t st[3] = {d[0].stride, d[1].stride, d[2].stride};
  cuuint32_t box[4] = {64, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    pos[d[i].which] = i + 1;
    if (d[i].which == 0) box[i + 1] = kRows;
  }
  return sm90::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 4, dims, st, box);
}

// The quantising instantiations run as clusters of the H CTAs of one query
// tile (cluster dims (1, H, 1), H <= 8): cudaLaunchKernelEx with a cluster
// dimension.  A refused launch returns its error.
template <int DP, int NWG, int OUT>
cudaLaunchConfig_t cluster_config(const FwdParams& p, int smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.Tq + kRows * NWG - 1) / (kRows * NWG), p.H, p.B);
  cfg.blockDim = dim3(128 * NWG + 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = p.H;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int DP, int NWG, int OUT>
int launch_out(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
               const FwdParams& p, cudaStream_t s) {
  const int smem = fwd_smem_bytes(DP, NWG, p.stages);
  if constexpr (OUT == kOutQ8F32 || OUT == kOutQ8Bf16) {
    if (p.H < 1 || p.H > kMaxClusterHeads) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config<DP, NWG, OUT>(p, smem, s, &attr);
    const cudaError_t e = cudaLaunchKernelEx(&cfg, attention_kernel<DP, NWG, OUT>, mq, mk, mv, p);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    const dim3 grid((p.Tq + kRows * NWG - 1) / (kRows * NWG), p.H, p.B);
    attention_kernel<DP, NWG, OUT><<<grid, 128 * NWG + 32, smem, s>>>(mq, mk, mv, p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int NWG>
int launch_bf16(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                const FwdParams& p, int out, cudaStream_t s) {
  switch (out) {
    case kOutBf16: return launch_out<DP, NWG, kOutBf16>(mq, mk, mv, p, s);
    case kOutF32: return launch_out<DP, NWG, kOutF32>(mq, mk, mv, p, s);
    case kOutQ8F32: return launch_out<DP, NWG, kOutQ8F32>(mq, mk, mv, p, s);
    case kOutQ8Bf16: return launch_out<DP, NWG, kOutQ8Bf16>(mq, mk, mv, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int DP>
int launch_bf16(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                const FwdParams& p, int nwg, int out, cudaStream_t s) {
  switch (nwg) {
    case 1: return launch_bf16<DP, 1>(mq, mk, mv, p, out, s);
    case 2: return launch_bf16<DP, 2>(mq, mk, mv, p, out, s);
    case 3: return launch_bf16<DP, 3>(mq, mk, mv, p, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int DP, int NWG>
cudaError_t set_fwd_smem() {
  const int smem = fwd_smem_bytes(DP, NWG, kMaxStages);
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e = cudaFuncSetAttribute(attention_kernel<DP, NWG, kOutBf16>, attr, smem);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(attention_kernel<DP, NWG, kOutF32>, attr, smem);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(attention_kernel<DP, NWG, kOutQ8F32>, attr, smem);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(attention_kernel<DP, NWG, kOutQ8Bf16>, attr, smem);
  return e;
}

// How many clusters of H CTAs of the quantising instantiation for (D, nwg,
// stages) the card holds at once (cudaOccupancyMaxActiveClusters); a
// negative value is a CUDA error.
template <int DP, int NWG>
int q8_clusters(int H, int stages) {
  FwdParams p{};
  p.H = H;
  p.B = 1;
  p.Tq = kRows * NWG;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<DP, NWG, kOutQ8F32>(
      p, fwd_smem_bytes(DP, NWG, stages), nullptr, &attr);
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, attention_kernel<DP, NWG, kOutQ8F32>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// ---------------------------------------------------------------------------
// f32 inputs: whole rows in shared memory, CUDA-core FMA.  Thread block of
// 8 warps, warp w owns query row q0 + w.  K and V rows are padded to D + 4
// floats (16-byte aligned for cp.async; the eight rows a quarter-warp reads
// at one float4 fall in eight different 16-byte bank groups).
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 8, kF32Threads = 32 * kF32Rows, kF32Chunk = 128;

struct F32Params {
  const float *q, *k, *v;
  float* o;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st;
  float* stats;
  const bool* kpm;
  const float* amask;
  int B, H, Tq, Tk, zero_attn;
  float scale;
};

// ops/attention.py does not plan this kernel: keys per chunk and the
// shared memory follow from Tk and D alone.
__host__ __device__ constexpr int f32_smem_bytes(int d, int kc) {
  return ((2 * kc + kF32Rows) * (d + 4) + kF32Rows * kc) * 4;
}

template <int D>
__device__ __forceinline__ void load_rows_f32(float* s, const float* g, long long st, int row0,
                                              int rows, int tid) {
  constexpr int LD = D + 4, CPR = D / 4;  // 16-byte chunks per row
  for (int c = tid; c < rows * CPR; c += kF32Threads) {
    const int r = c / CPR, cc = (c % CPR) * 4;
    mm::cp_async16(s + r * LD + cc, g + (size_t)(row0 + r) * st + cc, 16);
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) attention_f32_kernel(const F32Params p) {
  constexpr int LD = D + 4, NC = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kc = min(p.Tk, kF32Chunk);
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + kc * LD;
  float* sQ = sV + kc * LD;        // kF32Rows x LD
  float* sP = sQ + kF32Rows * LD;  // kF32Rows x kc

  const int q0 = blockIdx.x * kF32Rows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, row = q0 + warp;
  const float* Q = p.q + b * p.q_sb + h * p.q_sh;
  const float* K = p.k + b * p.k_sb + h * p.k_sh;
  const float* V = p.v + b * p.v_sb + h * p.v_sh;
  load_rows_f32<D>(sQ, Q, p.q_st, q0, min(kF32Rows, p.Tq - q0), tid);

  float m = p.zero_attn ? 0.f : -INFINITY;  // the zero key: logit 0, value 0
  float l = p.zero_attn ? 1.f : 0.f;
  float o[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) o[j] = 0.f;
  const float* q = sQ + warp * LD;
  float* pw = sP + warp * kc;

  for (int c0 = 0; c0 < p.Tk; c0 += kc) {
    const int nk = min(kc, p.Tk - c0);
    if (c0 > 0) __syncthreads();  // every warp is done with the previous chunk
    load_rows_f32<D>(sK, K, p.k_st, c0, nk, tid);
    load_rows_f32<D>(sV, V, p.v_st, c0, nk, tid);
    mm::cp_async_commit();
    mm::cp_async_wait<0>();
    __syncthreads();
    if (row < p.Tq) {
      // Logits: lane takes keys lane, lane + 32, ...
      float mx = -INFINITY;
      for (int kk = lane; kk < nk; kk += 32) {
        const float* kr = sK + kk * LD;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 a = *reinterpret_cast<const float4*>(q + d);
          const float4 c = *reinterpret_cast<const float4*>(kr + d);
          acc = fmaf(a.x, c.x, acc);
          acc = fmaf(a.y, c.y, acc);
          acc = fmaf(a.z, c.z, acc);
          acc = fmaf(a.w, c.w, acc);
        }
        const int col = c0 + kk;
        float v = acc * p.scale;
        if (p.kpm != nullptr && p.kpm[(size_t)b * p.Tk + col]) v += kMasked;
        if (p.amask != nullptr) v += p.amask[(size_t)row * p.Tk + col];
        pw[kk] = v;
        mx = fmaxf(mx, v);
      }
      const float mnew = fmaxf(m, mm::warp_max(mx));
      const float mref = mnew == -INFINITY ? 0.f : mnew;  // no finite logit yet
      const float alpha = expf(m - mref);
      float sum = 0.f;
      for (int kk = lane; kk < nk; kk += 32) {
        const float pv = expf(pw[kk] - mref);
        pw[kk] = pv;
        sum += pv;
      }
      m = mnew;
      l = l * alpha + mm::warp_sum(sum);
      __syncwarp();  // the row's p is written and read by this warp alone
#pragma unroll
      for (int j = 0; j < NC; ++j) o[j] *= alpha;
      for (int kk = 0; kk < nk; ++kk) {
        const float pv = pw[kk];
        const float* vr = sV + kk * LD + lane;
#pragma unroll
        for (int j = 0; j < NC; ++j) o[j] = fmaf(pv, vr[32 * j], o[j]);
      }
    }
  }
  if (row >= p.Tq) return;
  if (p.stats != nullptr && lane == 0) {
    const size_t n = (size_t)p.B * p.H * p.Tq, i = ((size_t)b * p.H + h) * p.Tq + row;
    p.stats[i] = m == -INFINITY ? 0.f : m;
    p.stats[n + i] = l > 0.f ? l : 1.f;
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  float* O = p.o + b * p.o_sb + h * p.o_sh + (size_t)row * p.o_st;
#pragma unroll
  for (int j = 0; j < NC; ++j) O[lane + 32 * j] = o[j] * inv;
}

template <int D>
int launch_f32(const F32Params& p, cudaStream_t s) {
  const dim3 grid((p.Tq + kF32Rows - 1) / kF32Rows, p.H, p.B);
  attention_f32_kernel<D>
      <<<grid, kF32Threads, f32_smem_bytes(D, min(p.Tk, kF32Chunk)), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 int64 values, (batch, head, row) strides of q, k, v, o in
// elements; the stride along D is 1.  kpm (B, Tk) bool (true = masked: a
// -1e30 bias) and amask (Tq, Tk) f32 additive may be null; stats
// (2, B, H, Tq) f32 is written when not null.  D in {64, 96, 128}; Tk >= 1.  q, k, v are bf16, or f32 when in_f32 (then
// o is f32 too); with bf16 inputs o is bf16, or f32 when out_f32, and nwg
// (1-3 warpgroups of 64 query rows per block) and stages (1-3 K/V stages)
// are the host's plan.
extern "C" int mm_attention(const void* q, const void* k, const void* v, void* o,
                            const long long* strides, const void* kpm, const void* amask,
                            void* stats, int B, int H, int Tq, int Tk, int D, int zero_attn,
                            float scale, int in_f32, int out_f32, int nwg, int stages,
                            void* stream) {
  if ((D != 64 && D != 96 && D != 128) || Tk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_f32) {
    F32Params p;
    p.q = static_cast<const float*>(q);
    p.k = static_cast<const float*>(k);
    p.v = static_cast<const float*>(v);
    p.o = static_cast<float*>(o);
    p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_st = strides[2];
    p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_st = strides[5];
    p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_st = strides[8];
    p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_st = strides[11];
    p.stats = static_cast<float*>(stats);
    p.kpm = static_cast<const bool*>(kpm);
    p.amask = static_cast<const float*>(amask);
    p.B = B;
    p.H = H;
    p.Tq = Tq;
    p.Tk = Tk;
    p.zero_attn = zero_attn;
    p.scale = scale;
    switch (D) {
      case 64: return launch_f32<64>(p, s);
      case 96: return launch_f32<96>(p, s);
      default: return launch_f32<128>(p, s);
    }
  }
  if (nwg < 1 || nwg > kMaxWarpgroups || stages < 1 || stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p{};
  p.o = o;
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_st = strides[11];
  p.stats = static_cast<float*>(stats);
  p.kpm = static_cast<const bool*>(kpm);
  p.amask = static_cast<const float*>(amask);
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.zero_attn = zero_attn;
  p.stages = stages;
  p.scale = scale;
  CUtensorMap mq, mk, mv;
  if (!view_map(&mq, q, strides, B, H, Tq, D, p.pos[0]) ||
      !view_map(&mk, k, strides + 3, B, H, Tk, D, p.pos[1]) ||
      !view_map(&mv, v, strides + 6, B, H, Tk, D, p.pos[2]))
    return static_cast<int>(cudaErrorInvalidValue);
  return D == 64 ? launch_bf16<64>(mq, mk, mv, p, nwg, out_f32 ? kOutF32 : kOutBf16, s)
                 : launch_bf16<128>(mq, mk, mv, p, nwg, out_f32 ? kOutF32 : kOutBf16, s);
}

// attention_q8: the bf16-input kernel with the quantising epilogue.  q, k, v
// as for mm_attention (bf16 views, D in {64, 128}); o8 the int8 (B, Tq, H D)
// output as a (B, H, Tq, D) view (strides[9..11], in elements), qscale the
// (B, Tq) f32 row scales.  round_bf16: quantise the output's bf16 rounding
// (what quant_rows reads of a bf16 output), else its f32 values.  H <= 8
// (one cluster of H CTAs per query tile); nwg and stages from the host plan.
extern "C" int mm_attention_q8(const void* q, const void* k, const void* v, void* o8,
                               const long long* strides, const void* kpm, void* qscale, int B,
                               int H, int Tq, int Tk, int D, int zero_attn, float scale,
                               int round_bf16, int nwg, int stages, void* stream) {
  if ((D != 64 && D != 128) || Tk < 1 || H < 1 || H > kMaxClusterHeads || nwg < 1 ||
      nwg > kMaxWarpgroups || stages < 1 || stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p{};
  p.o = o8;
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_st = strides[11];
  p.qscale = static_cast<float*>(qscale);
  p.kpm = static_cast<const bool*>(kpm);
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.zero_attn = zero_attn;
  p.stages = stages;
  p.scale = scale;
  CUtensorMap mq, mk, mv;
  if (!view_map(&mq, q, strides, B, H, Tq, D, p.pos[0]) ||
      !view_map(&mk, k, strides + 3, B, H, Tk, D, p.pos[1]) ||
      !view_map(&mv, v, strides + 6, B, H, Tk, D, p.pos[2]))
    return static_cast<int>(cudaErrorInvalidValue);
  const int out = round_bf16 ? kOutQ8Bf16 : kOutQ8F32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_bf16<64>(mq, mk, mv, p, nwg, out, s)
                 : launch_bf16<128>(mq, mk, mv, p, nwg, out, s);
}

// How many clusters of attention_q8 (H CTAs of the plan's nwg and stages at
// head dim D) the card holds at once; negative: a CUDA error.
extern "C" int mm_attention_q8_clusters(int D, int H, int nwg, int stages) {
  if ((D != 64 && D != 128) || H < 1 || H > kMaxClusterHeads)
    return -static_cast<int>(cudaErrorInvalidValue);
  switch (nwg + 4 * (D == 128)) {
    case 1: return q8_clusters<64, 1>(H, stages);
    case 2: return q8_clusters<64, 2>(H, stages);
    case 3: return q8_clusters<64, 3>(H, stages);
    case 5: return q8_clusters<128, 1>(H, stages);
    case 6: return q8_clusters<128, 2>(H, stages);
    case 7: return q8_clusters<128, 3>(H, stages);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Once, when the library loads: the dynamic shared memory limits of every
// instantiation, never inside a launch that a graph may capture.
extern "C" int mm_attention_init() {
  cudaError_t e = set_fwd_smem<64, 1>();
  if (e == cudaSuccess) e = set_fwd_smem<64, 2>();
  if (e == cudaSuccess) e = set_fwd_smem<64, 3>();
  if (e == cudaSuccess) e = set_fwd_smem<128, 1>();
  if (e == cudaSuccess) e = set_fwd_smem<128, 2>();
  if (e == cudaSuccess) e = set_fwd_smem<128, 3>();
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attention_f32_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             f32_smem_bytes(64, kF32Chunk));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attention_f32_kernel<96>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             f32_smem_bytes(96, kF32Chunk));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attention_f32_kernel<128>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             f32_smem_bytes(128, kF32Chunk));
  return static_cast<int>(e);
}
