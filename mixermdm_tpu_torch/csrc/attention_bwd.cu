// attention_bwd: dq, dk, dv of softmax(Q K^T / sqrt(D) + key_bias) V with
// torch's add_zero_attn done algebraically, for bf16 or f32 inputs.
//
// Replaces mixermdm_tpu/ops/attention.py:_fused_attention_bwd_impl ->
// _attn_bwd_kernel (:323-439), the backward of the custom_vjp wrappers
// _fa_nomask / _fa_kpm.  It computes what the TPU kernel computes, with the
// same rounding points:
//   p    = softmax over the keys and the zero key (which joins the max and
//          adds exp(-max) to the denominator), f32;
//   dv   = round(p)^T g            (p rounded to the input dtype first);
//   dp   = g v^T;  dsum = rowsum(dp * p)  (the zero key has v = 0: no term);
//   ds   = round(p * (dp - dsum));
//   dq   = ds k * scale;  dk = ds^T q * scale.
// Every product accumulates in f32 and dq / dk / dv are rounded to the input
// dtype once.  The TPU kernel holds the whole T x T panel of one head in
// VMEM; an H100 block has 227 KB of shared memory and blocks run in no order,
// so the work is split the FlashAttention-2 way into two kernels, with no
// atomics and a deterministic result:
//   attn_bwd_dq_kernel    one block per (batch, head, 32-query tile): three
//                         passes over the key tiles recompute the row max and
//                         denominator, then dsum, then dq; writes the row
//                         statistics (max, denominator, dsum);
//   attn_bwd_dkdv_kernel  one block per (batch, head, 32-key tile): one pass
//                         over the query tiles with the saved statistics
//                         writes dk and dv.
// Products are f32 FMAs on the CUDA cores (bf16 inputs are widened exactly),
// so the f32 path has no TF32 rounding and both dtypes share one code path.
// Bound on the card: 5 * 2 * B*H*Tq*Tk*D operations; at the training shapes
// (T <= 300, D 64 / 96) a simple design is far from it, and making it fast
// (tensor cores, TMA) is later work.
#include "common.cuh"

using mm::bf16;

namespace {

constexpr int TB = 32, kThreads = 256;  // 32-row tiles; 8 threads per row

struct Params {
  const void *q, *k, *v, *g;  // (B, H, T, D) contiguous, bf16 or f32
  void *dq, *dk, *dv;         // same layout and dtype
  float* stats;               // (3, B, H, Tq): row max, denominator, dsum
  const float* kbias;         // (B, Tk) additive, or null
  int B, H, Tq, Tk, zero_attn;
  float scale;
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// The value rounded to the input dtype and widened again.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f<T>(from_f<T>(x)); }

// Rows row0.. of a (rows_total, D) matrix into shared rows of D + 1 floats,
// zeros past the edge.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* s, const T* g, int row0, int rows_total,
                                          int tid) {
  for (int i = tid; i < TB * D; i += kThreads) {
    const int r = i / D, d = i % D;
    s[r * (D + 1) + d] = row0 + r < rows_total ? to_f<T>(g[(size_t)(row0 + r) * D + d]) : 0.f;
  }
}

// acc[i] = sum_d A[ra][d] * Bm[kc + 8 i][d]: four dot products of one shared
// row of A with four shared rows of Bm.
template <int D>
__device__ __forceinline__ void dot4(float* acc, const float* A, int ra, const float* Bm,
                                     int kc) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float a = A[ra * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = fmaf(a, Bm[(kc + 8 * i) * LD + d], acc[i]);
  }
}

__device__ __forceinline__ float row8_max(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row8_sum(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Scaled logit of (query row, key col) with the key bias; keys past Tk are
// -inf (no term at all).
__device__ __forceinline__ float logit(const Params& p, float s, int b, int col) {
  if (col >= p.Tk) return -INFINITY;
  float v = s * p.scale;
  if (p.kbias != nullptr) v += p.kbias[(size_t)b * p.Tk + col];
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + 1, NC = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sG = sQ + TB * LD;
  float* sK = sG + TB * LD;
  float* sV = sK + TB * LD;
  float* sS = sV + TB * LD;  // TB x (TB + 1): ds of the tile

  const int q0 = blockIdx.x * TB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 3, kc = tid & 7, row = q0 + r;
  const size_t bh = (size_t)b * p.H + h;
  const T* Q = static_cast<const T*>(p.q) + bh * p.Tq * D;
  const T* G = static_cast<const T*>(p.g) + bh * p.Tq * D;
  const T* K = static_cast<const T*>(p.k) + bh * p.Tk * D;
  const T* V = static_cast<const T*>(p.v) + bh * p.Tk * D;
  load_tile<T, D>(sQ, Q, q0, p.Tq, tid);
  load_tile<T, D>(sG, G, q0, p.Tq, tid);

  // Pass 1: row max and denominator (online), zero key included.
  float m = p.zero_attn ? 0.f : -INFINITY, l = p.zero_attn ? 1.f : 0.f;
  for (int k0 = 0; k0 < p.Tk; k0 += TB) {
    __syncthreads();
    load_tile<T, D>(sK, K, k0, p.Tk, tid);
    __syncthreads();
    float s[4];
    dot4<D>(s, sQ, r, sK, kc);
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = logit(p, s[i], b, k0 + kc + 8 * i);
      mx = fmaxf(mx, s[i]);
    }
    const float mnew = fmaxf(m, row8_max(mx));
    const float mref = mnew == -INFINITY ? 0.f : mnew;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) sum += expf(s[i] - mref);
    l = l * expf(m - mref) + row8_sum(sum);
    m = mnew;
  }
  const float mref = m == -INFINITY ? 0.f : m;
  const float den = l > 0.f ? l : 1.f;  // p = exp(s - max) / den, as the TPU kernel divides

  // Pass 2: dsum = rowsum(dp * p).
  float dsum = 0.f;
  for (int k0 = 0; k0 < p.Tk; k0 += TB) {
    __syncthreads();
    load_tile<T, D>(sK, K, k0, p.Tk, tid);
    load_tile<T, D>(sV, V, k0, p.Tk, tid);
    __syncthreads();
    float s[4], dp[4];
    dot4<D>(s, sQ, r, sK, kc);
    dot4<D>(dp, sG, r, sV, kc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dsum += dp[i] * (expf(logit(p, s[i], b, k0 + kc + 8 * i) - mref) / den);
  }
  dsum = row8_sum(dsum);

  // Pass 3: ds = round(p * (dp - dsum)); dq = ds k.
  float acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < p.Tk; k0 += TB) {
    __syncthreads();
    load_tile<T, D>(sK, K, k0, p.Tk, tid);
    load_tile<T, D>(sV, V, k0, p.Tk, tid);
    __syncthreads();
    float s[4], dp[4];
    dot4<D>(s, sQ, r, sK, kc);
    dot4<D>(dp, sG, r, sV, kc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pv = expf(logit(p, s[i], b, k0 + kc + 8 * i) - mref) / den;
      sS[r * (TB + 1) + kc + 8 * i] = round_to<T>(pv * (dp[i] - dsum));
    }
    __syncwarp();  // a row's ds is written and read by the same eight lanes
    const int nk = min(TB, p.Tk - k0);
    for (int kk = 0; kk < nk; ++kk) {
      const float ds = sS[r * (TB + 1) + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[j] = fmaf(ds, sK[kk * LD + kc + 8 * j], acc[j]);
    }
  }
  if (row >= p.Tq) return;
  T* dQ = static_cast<T*>(p.dq) + (bh * p.Tq + row) * D;
#pragma unroll
  for (int j = 0; j < NC; ++j) dQ[kc + 8 * j] = from_f<T>(acc[j] * p.scale);
  if (kc == 0) {
    const size_t n = (size_t)p.B * p.H * p.Tq, i = bh * p.Tq + row;
    p.stats[i] = mref;
    p.stats[n + i] = den;
    p.stats[2 * n + i] = dsum;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv_kernel(const Params p) {
  constexpr int LD = D + 1, NC = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + TB * LD;
  float* sQ = sV + TB * LD;
  float* sG = sQ + TB * LD;
  float* sP = sG + TB * LD;        // [key][query]: round(p)
  float* sDS = sP + TB * (TB + 1);  // [key][query]: ds
  float* sStat = sDS + TB * (TB + 1);  // 3 x TB: the query tile's statistics

  const int k0 = blockIdx.x * TB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, kr = tid >> 3, qc = tid & 7, key = k0 + kr;
  const size_t bh = (size_t)b * p.H + h, n = (size_t)p.B * p.H * p.Tq;
  const T* Q = static_cast<const T*>(p.q) + bh * p.Tq * D;
  const T* G = static_cast<const T*>(p.g) + bh * p.Tq * D;
  const T* K = static_cast<const T*>(p.k) + bh * p.Tk * D;
  const T* V = static_cast<const T*>(p.v) + bh * p.Tk * D;
  load_tile<T, D>(sK, K, k0, p.Tk, tid);
  load_tile<T, D>(sV, V, k0, p.Tk, tid);

  float dk[NC], dv[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) dk[j] = dv[j] = 0.f;
  for (int q0 = 0; q0 < p.Tq; q0 += TB) {
    __syncthreads();
    load_tile<T, D>(sQ, Q, q0, p.Tq, tid);
    load_tile<T, D>(sG, G, q0, p.Tq, tid);
    if (tid < TB && q0 + tid < p.Tq) {
      const size_t i = bh * p.Tq + q0 + tid;
      sStat[tid] = p.stats[i];
      sStat[TB + tid] = p.stats[n + i];
      sStat[2 * TB + tid] = p.stats[2 * n + i];
    }
    __syncthreads();
    float s[4], dp[4];
    dot4<D>(s, sK, kr, sQ, qc);  // s[i] = q[qc + 8 i] . k[kr]
    dot4<D>(dp, sV, kr, sG, qc);  // dp[i] = g[qc + 8 i] . v[kr]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = qc + 8 * i;
      float pv = 0.f, ds = 0.f;
      if (q0 + qi < p.Tq && key < p.Tk) {
        pv = expf(logit(p, s[i], b, key) - sStat[qi]) / sStat[TB + qi];
        ds = round_to<T>(pv * (dp[i] - sStat[2 * TB + qi]));
      }
      sP[kr * (TB + 1) + qi] = round_to<T>(pv);
      sDS[kr * (TB + 1) + qi] = ds;
    }
    __syncwarp();  // a key's column is written and read by the same eight lanes
    const int nq = min(TB, p.Tq - q0);
    for (int qq = 0; qq < nq; ++qq) {
      const float pc = sP[kr * (TB + 1) + qq], ds = sDS[kr * (TB + 1) + qq];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        dv[j] = fmaf(pc, sG[qq * LD + qc + 8 * j], dv[j]);
        dk[j] = fmaf(ds, sQ[qq * LD + qc + 8 * j], dk[j]);
      }
    }
  }
  if (key >= p.Tk) return;
  T* dK = static_cast<T*>(p.dk) + (bh * p.Tk + key) * D;
  T* dV = static_cast<T*>(p.dv) + (bh * p.Tk + key) * D;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    dK[qc + 8 * j] = from_f<T>(dk[j] * p.scale);
    dV[qc + 8 * j] = from_f<T>(dv[j]);
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t s) {
  constexpr int f = static_cast<int>(sizeof(float));
  const int smem_dq = (4 * TB * (D + 1) + TB * (TB + 1)) * f;
  const int smem_dkdv = (4 * TB * (D + 1) + 2 * TB * (TB + 1) + 3 * TB) * f;
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(attn_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_dq);
    cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
    configured = true;
  }
  attn_bwd_dq_kernel<T, D><<<dim3((p.Tq + TB - 1) / TB, p.H, p.B), kThreads, smem_dq, s>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dkdv_kernel<T, D>
      <<<dim3((p.Tk + TB - 1) / TB, p.H, p.B), kThreads, smem_dkdv, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const Params& p, int D, cudaStream_t s) {
  switch (D) {
    case 64: return launch<T, 64>(p, s);
    case 96: return launch<T, 96>(p, s);
    case 128: return launch<T, 128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, g, dq: (B, H, Tq, D); k, v, dk, dv: (B, H, Tk, D); all contiguous, bf16,
// or f32 when in_f32.  stats: (3, B, H, Tq) f32 scratch.  kbias (B, Tk) f32
// or null.  D in {64, 96, 128}.  Two launches on the stream, in order.
extern "C" int mm_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                void* dq, void* dk, void* dv, void* stats, const void* kbias,
                                int B, int H, int Tq, int Tk, int D, int zero_attn, float scale,
                                int in_f32, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.stats = static_cast<float*>(stats);
  p.kbias = static_cast<const float*>(kbias);
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.zero_attn = zero_attn;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_f32 ? launch_dtype<float>(p, D, s) : launch_dtype<bf16>(p, D, s);
}
