// sa_block_i8x: the W8A8 self-attention block with the int8 levers of the
// JAX kernel experiments, as one launch.
//
// Replaces _sa_i8x_kernel (scripts/exp_kernels.py:655-747, sa_int8x,
// pallas_call :792): the shipped W8A8 block (_sa_block_kernel_q8) with
// (a) a static, calibrated activation scale for the QKV product: the
//     modulated rows quantised as round(xn * (1 / static_as)) and the
//     product dequantised as float(acc) * (s_col * static_as) + b, in that
//     order (:672-685), where the shipped block takes one scale per row;
// (b) int8 p.v: p normalised before it is quantised, p8 = round(127 p), v
//     quantised with one scale per sequence, out = float(p8 . v8) *
//     (vs / 127) (:702-734);
// (c) int8 q.k^T: q and k quantised with one scale per sequence each,
//     logits = float(q8 . k8) * (qs * ks * 1/sqrt(D)), left to right (:695-714).
// q, k and v stay f32 between the QKV product and the attention (the JAX
// kernel casts them only where it uses them in bf16), and the per-sequence
// scales are maxima over the sequence's whole padded block, all E columns:
// Tp rows of q, k and v (the padded rows hold shift-valued inputs, so they
// count).  They are taken in the QKV product's epilogue, one atomicMax on the
// float bits per warp and row group, and read after the next barrier.
//
// The phases are sa_common.cuh's with this file's attention phase.  Because
// p is normalised before it is quantised, the softmax cannot run online
// over the key tiles: pass 1 walks the keys for each row's max (zero key
// included) and denominator; pass 2 walks them again, recomputes the
// logits, forms p = exp(s - max) / denominator and multiplies (int8 P staged
// per warp in shared memory for the m16n8k32 A fragments; V^T quantised into
// shared memory as it is loaded).  The f32 output is quantised per row
// (quant_rows' arithmetic) for the int8 out-projection, as the JAX kernel's
// _qdot does.
//
// What bounds it on an H100: the products' int8 tensor-core operations,
// 2 B Tp E (4E + 2 Tp) over 1979 TOP/s, 0.039 ms at B 40, T 299, E 1024;
// the f32 projection (B Tp 3E x 4 bytes, 149 MB at B 40) moves through
// device memory twice, 0.09 ms at 3.35 TB/s, so the bytes bound it.  The
// design is the simple one (mma.sync tiles, one block per SM); it exists to
// measure the levers, not to be fast.
#include "sa_common.cuh"

namespace {

using mm::bf16;
using namespace mm::sa;

__device__ unsigned int g_bar[2];  // the grid barrier's state (sa_common.cuh)

// Four f32 values -> the 4 bytes of their int8 quantisation with scale s.
__device__ __forceinline__ uint32_t q8x4(const float4& v, float s) {
  return mm::q8(v.x, s) | (mm::q8(v.y, s) << 8) | (mm::q8(v.z, s) << 16) | (mm::q8(v.w, s) << 24);
}

// One attention unit: sequence b, head h, query rows q0..q0+127.  QQK: int8
// Q and K tiles (rows of D + 16 bytes), else bf16 (2D + 16); QPV: int8 V^T
// (rows of 80 bytes), else bf16 (144).
template <int D, bool QQK, bool QPV>
__device__ void i8x_tile(const Params& p, int b, int h, int q0, char* smem) {
  constexpr int QS = QQK ? D + 16 : 2 * D + 16;
  constexpr int VS = QPV ? kKeys + 16 : 2 * kKeys + 16;
  constexpr int KT = QQK ? D / 32 : D / 16;  // k-steps of S over D
  constexpr int NT = D / 8;
  constexpr int PS = kKeys + 16;             // bytes per row of a warp's P tile
  char* sQ = smem;
  char* sK = sQ + kQRows * (2 * D + 16);
  char* sV = sK + kKeys * (2 * D + 16);
  char* sP = sV + D * (2 * kKeys + 16);
  float* sBias = reinterpret_cast<float*>(sP + kWarps * 16 * PS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int E = p.E, E3 = 3 * E, Tp = p.Tp, f = p.flags;
  const float* qkv = static_cast<const float*>(p.qkv) + (size_t)b * Tp * E3 + h * D;
  // The per-sequence scales, max(amax, 1e-8) / 127.
  const float qs = fmaxf(__ldcg(p.amax + b), 1e-8f) / 127.f;
  const float ks = fmaxf(__ldcg(p.amax + p.B + b), 1e-8f) / 127.f;
  const float vs = fmaxf(__ldcg(p.amax + 2 * p.B + b), 1e-8f) / 127.f;
  const float qk_scale = __fmul_rn(__fmul_rn(qs, ks), p.attn_scale);

  // A row of four f32 values of q or k, stored as int8 (QQK) or bf16.
  auto put_qk = [&](char* dst, const float4& v, float s) {
    if constexpr (QQK) {
      *reinterpret_cast<uint32_t*>(dst) = q8x4(v, s);
    } else {
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(mm::pack_bf16x2(v.x, v.y), mm::pack_bf16x2(v.z, v.w));
    }
  };
  constexpr int EB = QQK ? 1 : 2;  // bytes per q / k element in shared memory

  __syncthreads();
  for (int c = tid; c < kQRows * (D / 4); c += kThreads) {
    const int r = c / (D / 4), d = (c % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Tp) v = __ldcg(reinterpret_cast<const float4*>(qkv + (size_t)(q0 + r) * E3 + d));
    put_qk(sQ + r * QS + EB * d, v, qs);
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

  // K (and, in pass 2, V^T) tile of keys k0..k0+63, and the keys' biases.
  auto load_keys = [&](int k0, bool with_v) {
    __syncthreads();
    for (int c = tid; c < kKeys * (D / 4); c += kThreads) {
      const int j = c / (D / 4), d = (c % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + j < Tp) {
        const float* src = qkv + (size_t)(k0 + j) * E3 + d;
        kv = __ldcg(reinterpret_cast<const float4*>(src + E));
        if (with_v) vv = __ldcg(reinterpret_cast<const float4*>(src + 2 * E));
      }
      put_qk(sK + j * QS + EB * d, kv, ks);
      if (with_v) {
        const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (QPV)
            *reinterpret_cast<int8_t*>(sV + (d + i) * VS + j) =
                static_cast<int8_t>(mm::q8(vf[i], vs));
          else
            *reinterpret_cast<bf16*>(sV + (d + i) * VS + 2 * j) = __float2bfloat16_rn(vf[i]);
        }
      }
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
  };

  // The biased logits of this warp's 16 rows x 64 keys: s[n][e] at row
  // g + 8 (e / 2), key k0 + 8 n + 2 t + e % 2.
  auto logits = [&](float (&s)[8][4]) {
    if constexpr (QQK) {
      int si[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) si[n][e] = 0;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const char* pk = sK + (n * 8 + g) * QS + kk * 32 + 4 * t;
          const uint32_t bk[2] = {ld32(pk), ld32(pk + 16)};
          mma_s8(si[n], qf[kk], bk);
        }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = __fadd_rn(__fmul_rn(static_cast<float>(si[n][e]), qk_scale),
                              sBias[n * 8 + 2 * t + (e & 1)]);
    } else {
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
        for (int e = 0; e < 4; ++e)
          s[n][e] = __fadd_rn(__fmul_rn(s[n][e], p.attn_scale), sBias[n * 8 + 2 * t + (e & 1)]);
    }
  };

  // Pass 1: each row's max (the zero key's 0 included) and denominator.
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = (f & kZeroAttn) ? 0.f : -INFINITY;
    l[i] = ((f & kZeroAttn) && t == 0) ? 1.f : 0.f;
  }
  for (int k0 = 0; k0 < Tp; k0 += kKeys) {
    load_keys(k0, false);
    if (!active) continue;
    float s[8][4];
    logits(s);
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
      l[i] *= ex2((m[i] - mref[i]) * kLog2e);
      m[i] = mnew;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += ex2((s[n][e] - mref[e >> 1]) * kLog2e);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (m[i] == -INFINITY) m[i] = 0.f;
  }

  // Pass 2: p = exp(s - max) / denominator, then P V.
  using OAcc = typename std::conditional<QPV, int, float>::type;
  OAcc o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0;
  char* sPw = sP + warp * 16 * PS;
  for (int k0 = 0; k0 < Tp; k0 += kKeys) {
    load_keys(k0, true);
    if (!active) continue;
    float s[8][4];
    logits(s);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __fdiv_rn(ex2((s[n][e] - m[e >> 1]) * kLog2e), l[e >> 1]);
    if constexpr (QPV) {
      // p8 = round(127 p) (p <= 1), staged as this warp's 16 x 64 int8 tile.
      __syncwarp();
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t lo = static_cast<uint32_t>(static_cast<int>(rintf(__fmul_rn(s[n][2 * i], 127.f)))) & 0xffu;
          const uint32_t hi = static_cast<uint32_t>(static_cast<int>(rintf(__fmul_rn(s[n][2 * i + 1], 127.f)))) & 0xffu;
          *reinterpret_cast<uint16_t*>(sPw + (g + 8 * i) * PS + n * 8 + 2 * t) =
              static_cast<uint16_t>(lo | (hi << 8));
        }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < kKeys / 32; ++kk) {
        const char* pa = sPw + g * PS + kk * 32 + 4 * t;
        const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * PS), ld32(pa + 16), ld32(pa + 8 * PS + 16)};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const char* pv = sV + (n * 8 + g) * VS + kk * 32 + 4 * t;
          const uint32_t bv[2] = {ld32(pv), ld32(pv + 16)};
          mma(o[n], a, bv);
        }
      }
    } else {
      uint32_t pf[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        pf[n >> 1][(n & 1) * 2 + 0] = mm::pack_bf16x2(s[n][0], s[n][1]);
        pf[n >> 1][(n & 1) * 2 + 1] = mm::pack_bf16x2(s[n][2], s[n][3]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const char* pv = sV + (n * 8 + g) * VS + kk * 32 + 4 * t;
          const uint32_t bv[2] = {ld32(pv), ld32(pv + 16)};
          mma(o[n], pf[kk], bv);
        }
    }
  }
  if (!active) return;

  const float v_scale = vs / 127.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    if (row >= Tp) continue;
    float* dst = static_cast<float*>(p.attn) + ((size_t)b * Tp + row) * E + h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float y0, y1;
      if constexpr (QPV) {
        y0 = __fmul_rn(static_cast<float>(o[n][2 * i]), v_scale);
        y1 = __fmul_rn(static_cast<float>(o[n][2 * i + 1]), v_scale);
      } else {
        y0 = static_cast<float>(o[n][2 * i]);
        y1 = static_cast<float>(o[n][2 * i + 1]);
      }
      *reinterpret_cast<float2*>(dst + n * 8) = make_float2(y0, y1);
    }
  }
}

template <int D, bool QQK, bool QPV>
__device__ void i8x_attention_phase(const Params& p, char* smem) {
  const int QT = (p.Tp + kQRows - 1) / kQRows;
  const int units = p.B * p.H * QT;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int qt = u % QT, h = (u / QT) % p.H, b = u / (QT * p.H);
    i8x_tile<D, QQK, QPV>(p, b, h, qt * kQRows, smem);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) sa_block_i8x_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) char smem[];
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < 3 * p.B; i += kThreads) p.amax[i] = 0.f;
  ln_phase(p);
  grid_sync(g_bar);

  // The f32 projection, and each sequence's max |q|, |k|, |v|: a thread's
  // row max over its 8 columns, the quad's over the warp's 32 columns of one
  // section (q, k or v), then one atomicMax per warp where its 8 rows lie in
  // one sequence, else one per row.
  float rmax = 0.f;
  int sec = 0;
  qkv_phase(
      p, smem,
      [&](int row, int col, float v0, float v1) {
        *reinterpret_cast<float2*>(static_cast<float*>(p.qkv) + (size_t)row * 3 * p.E + col) =
            make_float2(v0, v1);
        rmax = fmaxf(rmax, fmaxf(fabsf(v0), fabsf(v1)));
        sec = col / p.E;
      },
      [&](int row) {
        const int t = threadIdx.x & 3;
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
        const int seq = row < p.B * p.Tp ? row / p.Tp : -1;
        const int seq0 = __shfl_sync(0xffffffffu, seq, 0);
        const int sec0 = __shfl_sync(0xffffffffu, sec, 0);
        unsigned int* amax = reinterpret_cast<unsigned int*>(p.amax);
        if (__all_sync(0xffffffffu, seq == seq0)) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
          if ((threadIdx.x & 31) == 0 && seq0 >= 0)
            atomicMax(amax + sec0 * p.B + seq0, __float_as_uint(rmax));
        } else if (t == 0 && seq >= 0) {
          atomicMax(amax + sec0 * p.B + seq, __float_as_uint(rmax));
        }
        rmax = 0.f;
      });
  grid_sync(g_bar);

  switch ((p.flags & kQqk ? 1 : 0) + (p.flags & kQpv ? 2 : 0)) {
    case 0: i8x_attention_phase<D, false, false>(p, smem); break;
    case 1: i8x_attention_phase<D, true, false>(p, smem); break;
    case 2: i8x_attention_phase<D, false, true>(p, smem); break;
    default: i8x_attention_phase<D, true, true>(p, smem);
  }
  grid_sync(g_bar);
  quant_attn_phase(p);
  grid_sync(g_bar);
  out_phase(p, smem);
}

template <int D>
int occupancy() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, sa_block_i8x_kernel<D>, kThreads, sa_smem_bytes(D, true));
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace

// As mm_sa_block (sa_block.cu) with int8 weights always (flags & 1): qkv is
// (M, 3E) f32; amax: (3, B) f32 scratch for the per-sequence maxima;
// inv_static, static_as: 1 / static_as and static_as as f32 (flags & 512);
// flags & 1024 int8 p.v, flags & 2048 int8 q.k^T.
extern "C" int mm_sa_block_i8x(const void* x, const void* scale, long long lds,
                               const void* shift, long long ldh, const void* w_qkv,
                               const void* b_qkv, const void* s_qkv, const void* w_o,
                               const void* b_o, const void* s_o, const void* kpm, void* out,
                               void* xn, void* xs, void* qkv, void* attn, void* a8, void* as,
                               void* amax, int B, int T, int Tp, int E, int H, int flags,
                               float attn_scale, float eps, float inv_static, float static_as,
                               int grid, void* stream) {
  if (!shape_ok(B, T, Tp, E, H, grid) || !(flags & kQuant))
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
  p.amax = static_cast<float*>(amax);
  p.B = B;
  p.T = T;
  p.Tp = Tp;
  p.E = E;
  p.H = H;
  p.rows = 1;
  p.flags = flags;
  p.attn_scale = attn_scale;
  p.eps = eps;
  p.inv_static = inv_static;
  p.static_as = static_as;
  const int D = E / H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64
             ? launch(sa_block_i8x_kernel<64>, p, grid, sa_smem_bytes(64, true), s)
             : launch(sa_block_i8x_kernel<128>, p, grid, sa_smem_bytes(128, true), s);
}

// Blocks of the kernel for head dim D that one SM holds at once (negative:
// a CUDA error).
extern "C" int mm_sa_block_i8x_occupancy(int D) {
  if (D == 64) return occupancy<64>();
  if (D == 128) return occupancy<128>();
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Once, when the library loads: the dynamic shared memory limits.
extern "C" int mm_sa_block_i8x_init() {
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e = cudaFuncSetAttribute(sa_block_i8x_kernel<64>, attr, sa_smem_bytes(64, true));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(sa_block_i8x_kernel<128>, attr, sa_smem_bytes(128, true));
  return static_cast<int>(e);
}
