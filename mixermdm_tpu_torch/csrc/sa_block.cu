// sa_block: the whole self-attention block of the JAX kernel experiments,
// x + out_proj(MHA(AdaLN(x))), as one launch.
//
// Replaces the Pallas kernels of scripts/exp_kernels.py that compute the
// block in one program: _sa_v_kernel / _sa_v_kernel_q8 (sa_variant, the
// merged (E, 3E) QKV product, R sequences per program, optional
// reciprocal-multiply softmax; pallas_call :204), _sa_hb_kernel / _hb_q8
// (sa_headbatch, the heads in one batched product; :595) and
// _sa_abl_kernel / _abl_q8 (sa_ablate, with LayerNorm, attention or softmax
// switched off, timing only; :433).  Their options are runtime flags of one
// kernel (sa_common.cuh) and the phases are sa_common.cuh's; this file holds
// the attention phase:
// - work units: (group of `rows` sequences, head, 128-row query tile), or
//   with kHeadBatch (sequence, query tile) walking all heads; a unit walks
//   its sequences and heads in turn, so the output does not depend on the
//   schedule;
// - per unit, the Q tile (bf16 rows of the packed projection) sits in
//   shared memory and each warp keeps its 16 rows' A fragments in
//   registers; K and V come 64 keys at a time, V stored transposed so that
//   the P.V fragments are 32-bit loads; S = Q K^T and O += P V on mma.sync
//   m16n8k16, f32 sums;
// - an online softmax in f32 started at (max 0, sum 1) for the zero key of
//   add_zero_attn, one ex2.approx per logit (as the port's attention
//   kernel); the bias -1e30 at padded (T <= key < Tp) and masked keys,
//   -inf past Tp; out = O / l, or O * (1 / l) with kRecip;
// - kSkipSoftmax: p = the biased logit rounded to bf16, no max, exp or
//   denominator (keys past Tp give 0); kSkipAttn skips the phase (the
//   out-projection reads v).
// The output is bf16 (f32 with kQuant, for the per-row quantisation).
//
// What bounds it on an H100: the two products' tensor-core operations,
// 2 B Tp E (4E + 2 Tp) at the JAX cost estimate (exp_kernels.py:214), 0.077
// ms at B 40, T 299, E 1024 over 989 TFLOP/s bf16.  The design is the simple
// one: mma.sync tiles (wgmma is what reaches that rate), a cp.async ring,
// one block per SM, the intermediates through device memory (L2 holds most
// of them); what it buys is one launch where the shipped block takes four.
#include "sa_common.cuh"

namespace {

using mm::bf16;
using namespace mm::sa;

__device__ unsigned int g_bar[2];  // the grid barrier's state (sa_common.cuh)

// One attention unit: sequence b, head h, query rows q0..q0+127.
template <int D>
__device__ void attention_tile(const Params& p, int b, int h, int q0, char* smem) {
  constexpr int QS = 2 * D + 16;       // bytes per Q / K row
  constexpr int VS = 2 * kKeys + 16;   // bytes per V^T row
  constexpr int KT = D / 16;           // k-steps of S over D
  constexpr int NT = D / 8;            // n8 tiles of O
  char* sQ = smem;
  char* sK = sQ + kQRows * QS;
  char* sV = sK + kKeys * QS;
  float* sBias = reinterpret_cast<float*>(sV + D * VS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int E3 = 3 * p.E, Tp = p.Tp, f = p.flags;
  const bool skip_sm = f & kSkipSoftmax;
  const bf16* qkv = static_cast<const bf16*>(p.qkv) + (size_t)b * Tp * E3 + h * D;

  __syncthreads();  // the previous unit is done with the tiles
  for (int c = tid; c < kQRows * (D / 8); c += kThreads) {
    const int r = c / (D / 8), d = (c % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Tp) v = __ldcg(reinterpret_cast<const uint4*>(qkv + (size_t)(q0 + r) * E3 + d));
    *reinterpret_cast<uint4*>(sQ + r * QS + 2 * d) = v;
  }
  __syncthreads();

  const int wr = warp * 16;
  const bool active = q0 + wr < Tp;
  uint32_t qf[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const char* pq = sQ + (wr + g) * QS + kk * 32 + 4 * t;
    qf[kk][0] = ld32(pq);
    qf[kk][1] = ld32(pq + 8 * QS);
    qf[kk][2] = ld32(pq + 16);
    qf[kk][3] = ld32(pq + 8 * QS + 16);
  }
  // Running state of rows g and g + 8; the sum per thread (a quarter of the
  // keys), so the zero key's 1 goes to one lane of the four.
  float m[2], l[2], o[NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = (f & kZeroAttn) ? 0.f : -INFINITY;
    l[i] = ((f & kZeroAttn) && t == 0) ? 1.f : 0.f;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int k0 = 0; k0 < Tp; k0 += kKeys) {
    __syncthreads();  // every warp is done with the previous K / V tile
    for (int c = tid; c < kKeys * (D / 8); c += kThreads) {
      const int j = c / (D / 8), d = (c % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + j < Tp) {
        const bf16* src = qkv + (size_t)(k0 + j) * E3 + d;
        kv = __ldcg(reinterpret_cast<const uint4*>(src + p.E));
        vv = __ldcg(reinterpret_cast<const uint4*>(src + 2 * p.E));
      }
      *reinterpret_cast<uint4*>(sK + j * QS + 2 * d) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) *reinterpret_cast<bf16*>(sV + (d + i) * VS + 2 * j) = ve[i];
    }
    if (tid < kKeys) {
      const int key = k0 + tid;
      float bias = 0.f;
      if (key >= Tp)
        bias = -INFINITY;
      else if (key >= p.T || (p.kpm != nullptr && p.kpm[(size_t)b * p.T + key]))
        bias = kMasked;
      sBias[tid] = bias;
    }
    __syncthreads();
    if (!active) continue;

    // S = Q K^T for 16 rows x 64 keys: thread holds s[n][e] at row g + 8 (e / 2),
    // key k0 + 8 n + 2 t + e % 2.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const char* pk = sK + (n * 8 + g) * QS + kk * 32 + 4 * t;
        const uint32_t bk[2] = {ld32(pk), ld32(pk + 16)};
        mma(s[n], qf[kk], bk);
      }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = fmaf(s[n][e], p.attn_scale, sBias[n * 8 + 2 * t + (e & 1)]);

    // P as bf16 A fragments: k-step kk covers keys 16 kk .. 16 kk + 15.
    uint32_t pf[4][4];
    if (skip_sm) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[e] = s[n][e] == -INFINITY ? 0.f : s[n][e];
        pf[n >> 1][(n & 1) * 2 + 0] = mm::pack_bf16x2(pv[0], pv[1]);
        pf[n >> 1][(n & 1) * 2 + 1] = mm::pack_bf16x2(pv[2], pv[3]);
      }
    } else {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      float mref[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mnew = fmaxf(m[i], mx[i]);
        mref[i] = mnew == -INFINITY ? 0.f : mnew;
        const float alpha = ex2((m[i] - mref[i]) * kLog2e);
        m[i] = mnew;
        l[i] *= alpha;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[n][2 * i] *= alpha;
          o[n][2 * i + 1] *= alpha;
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pv[e] = ex2((s[n][e] - mref[e >> 1]) * kLog2e);
          l[e >> 1] += pv[e];
        }
        pf[n >> 1][(n & 1) * 2 + 0] = mm::pack_bf16x2(pv[0], pv[1]);
        pf[n >> 1][(n & 1) * 2 + 1] = mm::pack_bf16x2(pv[2], pv[3]);
      }
    }

    // O += P V: V^T rows are d, 64 keys each.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const char* pv = sV + (n * 8 + g) * VS + kk * 32 + 4 * t;
        const uint32_t bv[2] = {ld32(pv), ld32(pv + 16)};
        mma(o[n], pf[kk], bv);
      }
  }
  if (!active) return;

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
  }
  const bool f32_out = f & kQuant;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    if (row >= Tp) continue;
    const size_t base = ((size_t)b * Tp + row) * p.E + h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float y0 = o[n][2 * i], y1 = o[n][2 * i + 1];
      if (!skip_sm) {
        if (f & kRecip) {
          y0 = __fmul_rn(y0, inv[i]);
          y1 = __fmul_rn(y1, inv[i]);
        } else {
          y0 = __fdiv_rn(y0, l[i]);
          y1 = __fdiv_rn(y1, l[i]);
        }
      }
      if (f32_out)
        *reinterpret_cast<float2*>(static_cast<float*>(p.attn) + base + n * 8) =
            make_float2(y0, y1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.attn) + base + n * 8) =
            mm::pack_bf16x2(y0, y1);
    }
  }
}

template <int D>
__device__ void attention_phase(const Params& p, char* smem) {
  const int QT = (p.Tp + kQRows - 1) / kQRows;
  const bool hb = p.flags & kHeadBatch;
  const int HU = hb ? 1 : p.H;
  const int units = (p.B / p.rows) * HU * QT;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int qt = u % QT, hu = (u / QT) % HU, bg = u / (QT * HU);
    for (int r = 0; r < p.rows; ++r)
      for (int h = hb ? 0 : hu; h < (hb ? p.H : hu + 1); ++h)
        attention_tile<D>(p, bg * p.rows + r, h, qt * kQRows, smem);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) sa_block_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) char smem[];
  ln_phase(p);
  grid_sync(g_bar);
  qkv_phase(p, smem, [&](int row, int col, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.qkv) + (size_t)row * 3 * p.E + col) =
        mm::pack_bf16x2(v0, v1);
  });
  grid_sync(g_bar);
  if (!(p.flags & kSkipAttn)) attention_phase<D>(p, smem);
  grid_sync(g_bar);
  if (p.flags & kQuant) {
    quant_attn_phase(p);
    grid_sync(g_bar);
  }
  out_phase(p, smem);
}

template <int D>
int occupancy() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, sa_block_kernel<D>, kThreads, sa_smem_bytes(D, false));
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace

// x: (B, T, E) bf16 contiguous; scale, shift: (B, E) bf16 with row strides
// lds, ldh (16-byte aligned rows); w_qkv: (3E, E), w_o: (E, E), bf16, or
// int8 with flags & 1 (then s_qkv, s_o: their f32 row scales); b_qkv,
// b_o: f32; kpm: (B, T) bool or null; out: (B, T, E) bf16.  Scratch, rows
// M = B * Tp: xn (M, E) bf16 or int8, xs (M,) f32, qkv (M, 3E) bf16, attn
// (M, E) bf16 or f32, a8 (M, E) int8, as (M,) f32 (the int8 ones with
// flags & 1 only).  grid: blocks the card holds at once
// (mm_sa_block_occupancy per SM; the host plan, ops/sa_variants.py:
// sa_block_plan), launched cooperatively.
extern "C" int mm_sa_block(const void* x, const void* scale, long long lds, const void* shift,
                           long long ldh, const void* w_qkv, const void* b_qkv,
                           const void* s_qkv, const void* w_o, const void* b_o, const void* s_o,
                           const void* kpm, void* out, void* xn, void* xs, void* qkv, void* attn,
                           void* a8, void* as, int B, int T, int Tp, int E, int H, int rows,
                           int flags, float attn_scale, float eps, int grid, void* stream) {
  if (!shape_ok(B, T, Tp, E, H, grid) || rows < 1 || B % rows)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = static_cast<const bf16*>(x);
  p.scale = static_cast<const bf16*>(scale);
  p.lds = lds;
  p.shift = static_cast<const bf16*>(shift);
  p.ldh = ldh;
  p.w_qkv = w_qkv;
  p.b_qkv = static_cast<const float*>(b_qkv);
  p.s_qkv = static_cast<const float*>(s_qkv);
  p.w_o = w_o;
  p.b_o = static_cast<const float*>(b_o);
  p.s_o = static_cast<const float*>(s_o);
  p.kpm = static_cast<const bool*>(kpm);
  p.out = static_cast<bf16*>(out);
  p.xn = xn;
  p.xs = static_cast<float*>(xs);
  p.qkv = qkv;
  p.attn = attn;
  p.a8 = static_cast<int8_t*>(a8);
  p.as = static_cast<float*>(as);
  p.B = B;
  p.T = T;
  p.Tp = Tp;
  p.E = E;
  p.H = H;
  p.rows = rows;
  p.flags = flags;
  p.attn_scale = attn_scale;
  p.eps = eps;
  const int D = E / H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch(sa_block_kernel<64>, p, grid, sa_smem_bytes(64, false), s)
                 : launch(sa_block_kernel<128>, p, grid, sa_smem_bytes(128, false), s);
}

// Blocks of the kernel for head dim D that one SM holds at once (negative:
// a CUDA error).
extern "C" int mm_sa_block_occupancy(int D) {
  if (D == 64) return occupancy<64>();
  if (D == 128) return occupancy<128>();
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Once, when the library loads: the dynamic shared memory limit of both
// instantiations, never inside a launch that a graph may capture.
extern "C" int mm_sa_block_init() {
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e = cudaFuncSetAttribute(sa_block_kernel<64>, attr, sa_smem_bytes(64, false));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(sa_block_kernel<128>, attr, sa_smem_bytes(128, false));
  return static_cast<int>(e);
}
