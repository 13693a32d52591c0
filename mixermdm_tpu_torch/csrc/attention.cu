// attention: softmax(Q K^T / sqrt(D) + key_bias + attn_mask) V with torch's
// add_zero_attn done algebraically, bf16 in and out, f32 softmax state.
//
// Replaces mixermdm_tpu/ops/attention.py:_attn_body (_attn_kernel,
// _attn_kernel_qk) and the per-head attention loop inside the Pallas block
// kernels (_sa_block_kernel, _ca_block_kernel).  The TPU kernel holds the
// whole T x T logit matrix in VMEM; here one block owns one (batch, head,
// 64-query tile) and streams 64-key tiles of K and V through shared memory
// with an online softmax (flash-attention style), so no logit ever reaches
// device memory.  At T = 299 the work is tensor-core bound in principle but
// small (grid of ~5 x H x B blocks); the design keeps it to one pass over
// Q, K, V.
//
// Zero-attn: the implicit zero key has logit 0 and value 0, so starting the
// running state at (max = 0, sum = 1, acc = 0) instead of (-inf, 0, 0) adds
// exactly exp(0 - max) to the denominator and nothing to the numerator.  Keys
// past Tk get -inf (excluded); masked keys get the caller's -1e30 bias, so a
// fully masked row stays finite exactly as in the reference.
//
// Operands are strided (batch, head, row) views with unit stride along D, so
// the fused blocks read Q/K/V straight out of the packed QKV projection.
//
// The output is bf16, or f32 for the W8A8 self-attention block: the JAX
// package quantises that block's attention output from f32
// (mixermdm_tpu/ops/fused_block.py:140-146, heads concatenated before any
// cast), so the f32 instantiation hands the unrounded values to quant_rows.
//
// f32 inputs (the f32 softmax branch of _attn_body, attention.py:60; on the
// port's paths the CLIP post-encoders, (B, 8, 77, 96), no zero-attn, no
// mask) take attention_f32_kernel: f32 in, f32 out, every product an f32 FMA
// on the CUDA cores.  No tensor core: a TF32 product keeps ~10 bits and could
// not meet the 1e-5 agreement the f32 path is held to.  One block owns a
// (batch, head, 32-query tile) and streams 32-key tiles of K and V through
// shared memory with the same online softmax and zero-attn initial state.
// At T = 77 it is latency-bound (48 blocks at B = 2); its bound on the card
// is the f32 FMA rate, 67 TFLOP/s.
#include "common.cuh"

using mm::bf16;

namespace {

constexpr int BQ = 64, BKV = 64, kThreads = 128;  // 4 warps x 16 query rows
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void *q, *k, *v;  // bf16, or f32 for attention_f32_kernel
  void* o;  // bf16, or f32 for the OF32 instantiation
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st;
  const float* kbias;  // (B, Tk) additive, or null
  const float* amask;  // (Tq, Tk) additive, or null
  int Tq, Tk, zero_attn;
  float scale;
};

template <int D>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g, long long st, int row0,
                                          int rows_total, int tid) {
  constexpr int LD = D + 8;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < 64 * CPR; c += kThreads) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    const bool ok = row0 + r < rows_total;
    mm::cp_async16(s + r * LD + cc, ok ? g + (size_t)(row0 + r) * st + cc : g, ok ? 16 : 0);
  }
}

template <int D, bool OF32>
__global__ void __launch_bounds__(kThreads) attention_kernel(const Params p) {
  constexpr int LD = D + 8;
  constexpr int NT = D / 8;  // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * LD;
  bf16* sV = sK + BKV * LD;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* K = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* V = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const long long o_off = b * p.o_sb + h * p.o_sh;

  load_rows<D>(sQ, Q, p.q_st, q0, p.Tq, tid);
  mm::cp_async_commit();
  mm::cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mm::ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  // Running state for this thread's two rows (lane/4 and lane/4 + 8).  The
  // row sum is kept per thread (one quarter of the columns) and reduced at
  // the end, so the zero key's 1 is credited to one lane of the four.
  float m[2], l[2];
  const float l0 = (p.zero_attn && (lane & 3) == 0) ? 1.f : 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = p.zero_attn ? 0.f : -INFINITY;
    l[i] = l0;
  }
  float o[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;

  const int r_lo = q0 + warp * 16 + (lane >> 2);  // rows r_lo and r_lo + 8

  for (int k0 = 0; k0 < p.Tk; k0 += BKV) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<D>(sK, K, p.k_st, k0, p.Tk, tid);
    load_rows<D>(sV, V, p.v_st, k0, p.Tk, tid);
    mm::cp_async_commit();
    mm::cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys per warp.
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t t4[4];
        mm::ldmatrix_x4(t4, sK + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                                ((lane >> 3) & 1) * 8);
        mm::mma_16816(s[2 * nj], qf[kk], t4);
        mm::mma_16816(s[2 * nj + 1], qf[kk], t4 + 2);
      }
    }

    // Scale, masks, running max.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r_lo + (e >> 1) * 8;
        const int col = k0 + t * 8 + (lane & 3) * 2 + (e & 1);
        float v = s[t][e] * p.scale;
        if (col >= p.Tk) {
          v = -INFINITY;
        } else {
          if (p.kbias != nullptr) v += p.kbias[(size_t)b * p.Tk + col];
          if (p.amask != nullptr && row < p.Tq) v += p.amask[(size_t)row * p.Tk + col];
        }
        s[t][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float mref[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mnew = fmaxf(m[i], mx[i]);
      mref[i] = mnew == -INFINITY ? 0.f : mnew;  // a row with no finite logit yet
      alpha[i] = exp2f((m[i] - mref[i]) * kLog2e);
      m[i] = mnew;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }

    // P = exp(S - max), packed to bf16 A fragments for P V.
    uint32_t pf[4][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = exp2f((s[t][e] - mref[e >> 1]) * kLog2e);
        l[e >> 1] += pv[e];
      }
      // key block j = t / 2: a0/a1 from the even n8 tile, a2/a3 from the odd one
      const int j = t >> 1, half = t & 1;
      pf[j][half * 2 + 0] = mm::pack_bf16x2(pv[0], pv[1]);
      pf[j][half * 2 + 1] = mm::pack_bf16x2(pv[2], pv[3]);
    }

    // O += P V; V tile is [key][d], read transposed for mma's col operand.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int dt = 0; dt < NT; dt += 2) {
        uint32_t t4[4];
        mm::ldmatrix_x4_trans(t4, sV + (j * 16 + (lane & 15)) * LD + dt * 8 + ((lane >> 4) << 3));
        mm::mma_16816(o[dt], pf[j], t4);
        mm::mma_16816(o[dt + 1], pf[j], t4 + 2);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + i * 8;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int col = t * 8 + (lane & 3) * 2;
      const long long off = o_off + (size_t)row * p.o_st + col;
      if (OF32)
        *reinterpret_cast<float2*>(static_cast<float*>(p.o) + off) =
            make_float2(o[t][2 * i] * l[i], o[t][2 * i + 1] * l[i]);
      else
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.o) + off) =
            mm::pack_bf16x2(o[t][2 * i] * l[i], o[t][2 * i + 1] * l[i]);
    }
  }
}

template <int D, bool OF32>
int launch(const Params& p, int B, int H, cudaStream_t s) {
  const int smem = 3 * 64 * (D + 8) * static_cast<int>(sizeof(bf16));
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(attention_kernel<D, OF32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    configured = true;
  }
  const dim3 grid((p.Tq + BQ - 1) / BQ, H, B);
  attention_kernel<D, OF32><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// f32 inputs: scalar FMA.  256 threads; thread t owns query row r = t / 8 of
// the tile and key / output columns c = t % 8 + 8 j, so a row's eight
// threads are eight neighbouring lanes of one warp and reduce with shuffles.
// Shared rows are padded to D + 1 floats, so the eight key rows a warp reads
// at one d fall in eight different banks.
// ---------------------------------------------------------------------------

constexpr int FB = 32, kF32Threads = 256;

template <int D>
__device__ __forceinline__ void load_rows_f32(float* s, const float* g, long long st, int row0,
                                              int rows_total, int tid) {
  for (int i = tid; i < FB * D; i += kF32Threads) {
    const int r = i / D, d = i % D;
    s[r * (D + 1) + d] = row0 + r < rows_total ? g[(size_t)(row0 + r) * st + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) attention_f32_kernel(const Params p) {
  constexpr int LD = D + 1, NC = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + FB * LD;
  float* sV = sK + FB * LD;
  float* sP = sV + FB * LD;  // FB x (FB + 1)

  const int q0 = blockIdx.x * FB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 3, kc = tid & 7;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int row = q0 + r;

  load_rows_f32<D>(sQ, Q, p.q_st, q0, p.Tq, tid);
  float m = p.zero_attn ? 0.f : -INFINITY;  // the zero key: logit 0, value 0
  float l = p.zero_attn ? 1.f : 0.f;
  float o[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) o[j] = 0.f;

  for (int k0 = 0; k0 < p.Tk; k0 += FB) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_rows_f32<D>(sK, K, p.k_st, k0, p.Tk, tid);
    load_rows_f32<D>(sV, V, p.v_st, k0, p.Tk, tid);
    __syncthreads();

    float s[FB / 8];
#pragma unroll
    for (int i = 0; i < FB / 8; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[r * LD + d];
#pragma unroll
      for (int i = 0; i < FB / 8; ++i) s[i] = fmaf(qd, sK[(kc + 8 * i) * LD + d], s[i]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < FB / 8; ++i) {
      const int col = k0 + kc + 8 * i;
      float v = s[i] * p.scale;
      if (col >= p.Tk) {
        v = -INFINITY;
      } else {
        if (p.kbias != nullptr) v += p.kbias[(size_t)b * p.Tk + col];
        if (p.amask != nullptr && row < p.Tq) v += p.amask[(size_t)row * p.Tk + col];
      }
      s[i] = v;
      mx = fmaxf(mx, v);
    }
#pragma unroll
    for (int o_ = 1; o_ < 8; o_ <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
    const float mnew = fmaxf(m, mx);
    const float mref = mnew == -INFINITY ? 0.f : mnew;  // no finite logit yet
    const float alpha = expf(m - mref);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < FB / 8; ++i) {
      const float pv = expf(s[i] - mref);
      sum += pv;
      sP[r * (FB + 1) + kc + 8 * i] = pv;
    }
#pragma unroll
    for (int o_ = 1; o_ < 8; o_ <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o_);
    m = mnew;
    l = l * alpha + sum;
    __syncwarp();  // a row's P is written and read by the same eight lanes
#pragma unroll
    for (int j = 0; j < NC; ++j) o[j] *= alpha;
    const int nk = min(FB, p.Tk - k0);
    for (int kk = 0; kk < nk; ++kk) {
      const float pv = sP[r * (FB + 1) + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) o[j] = fmaf(pv, sV[kk * LD + kc + 8 * j], o[j]);
    }
  }
  if (row >= p.Tq) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  float* O = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + (size_t)row * p.o_st;
#pragma unroll
  for (int j = 0; j < NC; ++j) O[kc + 8 * j] = o[j] * inv;
}

template <int D>
int launch_f32(const Params& p, int B, int H, cudaStream_t s) {
  const int smem = (3 * FB * (D + 1) + FB * (FB + 1)) * static_cast<int>(sizeof(float));
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(attention_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    configured = true;
  }
  const dim3 grid((p.Tq + FB - 1) / FB, H, B);
  attention_f32_kernel<D><<<grid, kF32Threads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}


template <int D>
int launch(const Params& p, int B, int H, int in_f32, int out_f32, cudaStream_t s) {
  if (in_f32) return launch_f32<D>(p, B, H, s);
  return out_f32 ? launch<D, true>(p, B, H, s) : launch<D, false>(p, B, H, s);
}

}  // namespace

// strides: 12 int64 values, (batch, head, row) strides of q, k, v, o in
// elements; the stride along D is 1.  kbias (B, Tk) and amask (Tq, Tk) are
// f32 and may be null.  D in {64, 96, 128}.  q, k, v are bf16, or f32 when
// in_f32 (then o is f32 too); with bf16 inputs o is bf16, or f32 when
// out_f32.
extern "C" int mm_attention(const void* q, const void* k, const void* v, void* o,
                            const long long* strides, const void* kbias, const void* amask,
                            int B, int H, int Tq, int Tk, int D, int zero_attn, float scale,
                            int in_f32, int out_f32, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_st = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_st = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_st = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_st = strides[11];
  p.kbias = static_cast<const float*>(kbias);
  p.amask = static_cast<const float*>(amask);
  p.Tq = Tq;
  p.Tk = Tk;
  p.zero_attn = zero_attn;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, B, H, in_f32, out_f32, s);
    case 96: return launch<96>(p, B, H, in_f32, out_f32, s);
    case 128: return launch<128>(p, B, H, in_f32, out_f32, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
