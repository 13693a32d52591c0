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
// the attention phase, after the design of csrc/attention.cu's bf16
// forward:
// - work units: (group of `rows` sequences, head, 64-row query tile), or
//   with kHeadBatch (sequence, query tile) walking all heads, one unit a
//   warpgroup, all three warpgroups of a block (sa_common.cuh: Walk); a
//   unit walks its sequences and heads in turn, so the output does not
//   depend on the schedule.  64-row tiles keep 3 of 4 warps busy in Tp
//   304's last tile (a 128-row tile left 5 of 8 idle), and three
//   warpgroups an SM hold B 8's 320 units in one wave (396 warpgroups);
// - each warpgroup has its own Q tile and ring of 32-key K/V stages (32,
//   not 64: three rings fit in shared memory), loaded by TMA straight out
//   of the packed (B, Tp, 3E) projection (rows past Tp zero-filled); its
//   thread 0 refills a stage once the warpgroup is done with it, and
//   issues the next tile's Q once the current tile's last Q K^T is done;
// - S = Q K^T on wgmma m64n32k16 from shared memory, O += P V on wgmma
//   m64nDk16 with P from registers (S's fragment packed to bf16) and V read
//   MN-major, f32 sums; a key's 32 logits a step keep the loop under the
//   168 registers of the launch bound;
// - an online softmax in f32 started at (max 0, sum 1) for the zero key of
//   add_zero_attn, one ex2.approx per logit (as the port's attention
//   kernel); the bias -1e30 at padded (T <= key < Tp) and masked keys,
//   -inf past Tp; out = O / l, or O * (1 / l) with kRecip;
// - kSkipSoftmax: p = the biased logit rounded to bf16, no max, exp or
//   denominator (keys past Tp give 0); kSkipAttn skips the phase (the
//   out-projection reads v).
// The output is bf16, or f32 with kQuant for the per-row quantisation,
// whose row maxima the tile's epilogue takes (row_max_out).  The output
// tile goes out through the warpgroup's staging, 128 bytes of each row at
// a time, as 16-byte pieces.
//
// What bounds it on an H100: the two products' tensor-core operations,
// 2 B Tp E (4E + 2 Tp) at the JAX cost estimate (exp_kernels.py:214):
// 117 GFLOP at B 40, T 299, E 1024, 0.118 ms at 989 TFLOP/s bf16 (0.116 on
// the T rows, the bound chip_smoke.py prints).
#include "sa_common.cuh"

namespace {

using mm::bf16;
using namespace mm::sa;

__device__ unsigned int g_bar[2];  // the grid barrier's state (sa_common.cuh)

// The attention phase, every warpgroup of the block: its tiles (Walk), each
// 64 query rows against the sequence's keys in 32-key steps.  Thread 0 of
// the warpgroup issues its loads: the Q tile of tile n, and load i (tile
// i / nkv, keys 32 (i % nkv)..) into K/V stage i % S, refilled once the
// warpgroup is done with it (the next tile's first loads and Q overlap the
// current tile's last steps and its output).
template <int D>
__device__ __forceinline__ void attention_phase(const Maps& maps, const Params& p, const Smem& sm) {
  constexpr int S = attn_stages(D), NT = D / 8, KS = D / 64;
  const int w = threadIdx.x >> 7, tid = threadIdx.x & 127, t = threadIdx.x & 3;
  const Walk walk(p, w * gridDim.x + blockIdx.x);
  const int nt = walk.count(), nkv = (p.Tp + kKeys - 1) / kKeys, loads = nt * nkv;
  uint8_t* q_tile = sm.q_tile<D>(w);
  uint8_t* kv0 = sm.kv_stage<D>(w, 0);
  uint64_t* qbar = sm.qfull(w);
  uint64_t* fbar = sm.kvfull(w);
  const uint32_t sQ = mm::smem_u32(q_tile), sKV = mm::smem_u32(kv0);
  auto issue_q = [&](int n) {
    int b, h, q0;
    walk.tile(n, b, h, q0);
    sm90::mbar_expect_tx(qbar, q_tile_bytes(D));
#pragma unroll
    for (int s = 0; s < KS; ++s)
      sm90::tma_load_3d(q_tile + s * kBoxBytes, &maps.q, qbar, h * D + 64 * s, q0, b);
  };
  auto issue_kv = [&](int i) {
    int b, h, q0;
    walk.tile(i / nkv, b, h, q0);
    const int j = i % nkv, st = i % S;
    uint8_t* dst = kv0 + st * kv_stage_bytes(D);
    sm90::mbar_expect_tx(&fbar[st], kv_stage_bytes(D));
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      sm90::tma_load_3d(dst + s * kKvBoxBytes, &maps.k, &fbar[st], p.E + h * D + 64 * s,
                        j * kKeys, b);
      sm90::tma_load_3d(dst + kv_stage_bytes(D) / 2 + s * kKvBoxBytes, &maps.v, &fbar[st],
                        2 * p.E + h * D + 64 * s, j * kKeys, b);
    }
  };
  if (tid == 0 && nt > 0) {
    issue_q(0);
    for (int i = 0; i < min(S, loads); ++i) issue_kv(i);
  }
  for (int n = 0; n < nt; ++n) {
    int b, h, q0;
    walk.tile(n, b, h, q0);
    const bool* kpm_b = p.kpm != nullptr ? p.kpm + (size_t)b * p.T : nullptr;
    Online st;
    st.start(p.flags & kZeroAttn, t);
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    sm90::mbar_wait(qbar, n & 1);
    int i = n * nkv;
    for (int j = 0; j < nkv; ++j, ++i) {
      const int sg = i % S;
      sm90::mbar_wait(&fbar[sg], (i / S) & 1);
      const uint32_t sK = sKV + sg * kv_stage_bytes(D), sV = sK + kv_stage_bytes(D) / 2;

      // S = Q K^T: 64 rows x 32 keys, K-major operands (32-row K boxes,
      // 4096 bytes a slab); thread holds s[4 c + e] at row g + 8 (e / 2)
      // of its warp's 16, key k0 + 8 c + 2 t + e % 2.
      const int k0 = j * kKeys;
      float s[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int slab = kk / 4, step = kk % 4;
        wgmma_n32(s, kdesc_s(opaque(sQ) + slab * kBoxBytes, 128) + 2 * step,
                  kdesc_s(opaque(sK) + slab * kKvBoxBytes, 128) + 2 * step, kk != 0);
      }
      sm90::wgmma_commit();
      const uint32_t mask = key_mask(kpm_b, p.T, k0, t);  // while it runs
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 16; ++e) sm90::reg_fence(s[e]);
      if (j == nkv - 1) {  // the tile's Q is done: the next tile's
        sm90::named_sync(1 + w);
        if (tid == 0 && n + 1 < nt) issue_q(n + 1);
      }
#pragma unroll
      for (int e = 0; e < 16; ++e)
        s[e] = fmaf(s[e], p.attn_scale, key_bias(mask, e, k0, t, p.T, p.Tp));

      // P as bf16 A fragments: k-step kk covers keys 16 kk .. 16 kk + 15.
      uint32_t pf[2][4];
      if (p.flags & kSkipSoftmax) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float pv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[e] = s[4 * c + e] == -INFINITY ? 0.f : s[4 * c + e];
          pf[c >> 1][(c & 1) * 2 + 0] = mm::pack_bf16x2(pv[0], pv[1]);
          pf[c >> 1][(c & 1) * 2 + 1] = mm::pack_bf16x2(pv[2], pv[3]);
        }
      } else {
        float mref[2], alpha[2];
        st.update(s, mref, alpha);
#pragma unroll
        for (int c = 0; c < NT; ++c) {
          o[4 * c + 0] *= alpha[0];
          o[4 * c + 1] *= alpha[0];
          o[4 * c + 2] *= alpha[1];
          o[4 * c + 3] *= alpha[1];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float pv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pv[e] = ex2((s[4 * c + e] - mref[e >> 1]) * kLog2e);
            st.l[e >> 1] += pv[e];
          }
          pf[c >> 1][(c & 1) * 2 + 0] = mm::pack_bf16x2(pv[0], pv[1]);
          pf[c >> 1][(c & 1) * 2 + 1] = mm::pack_bf16x2(pv[2], pv[3]);
        }
      }

      // O += P V: V [key][d] is N-major in 32-key slabs of 64 columns
      // (4096 bytes apart); 16 keys per k-step, 2048 bytes.
#pragma unroll
      for (int e = 0; e < D / 2; ++e) sm90::reg_fence(o[e]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        sm90::wgmma_bf16_rs<D>(o, pf[kk], mndesc_s(opaque(sV) + kk * 2048, kKvBoxBytes));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < D / 2; ++e) sm90::reg_fence(o[e]);
      sm90::named_sync(1 + w);  // the stage is free
      if (tid == 0 && i + S < loads) issue_kv(i + S);
    }

    const int f = p.flags;
    const bool skip_sm = f & kSkipSoftmax, f32_out = f & kQuant, recip = f & kRecip;
    const bool round_attn = f & kRoundAttn;
    st.reduce();
    const float inv[2] = {1.f / st.l[0], 1.f / st.l[1]};
    float amax[2] = {0.f, 0.f};  // of the values quant_attn_phase quantises
    auto val = [&](int c, int r, float& y0, float& y1) {
      y0 = o[4 * c + 2 * r];
      y1 = o[4 * c + 2 * r + 1];
      if (!skip_sm) {
        if (recip) {
          y0 = __fmul_rn(y0, inv[r]);
          y1 = __fmul_rn(y1, inv[r]);
        } else {
          y0 = __fdiv_rn(y0, st.l[r]);
          y1 = __fdiv_rn(y1, st.l[r]);
        }
      }
      if (f32_out) {
        const float a0 = round_attn ? bf16_round(y0) : y0, a1 = round_attn ? bf16_round(y1) : y1;
        amax[r] = fmaxf(amax[r], fmaxf(fabsf(a0), fabsf(a1)));
      }
    };
    uint8_t* stg = sm.attn_stg<D>(w);
    const size_t at = ((size_t)b * p.Tp + q0) * p.E + h * D;
    const int rows = min(kRows, p.Tp - q0);
    if (f32_out)
      stage_out<true, D>(stg, 1 + w, val, static_cast<float*>(p.attn) + at, p.E, rows);
    else
      stage_out<false, D>(stg, 1 + w, val, static_cast<bf16*>(p.attn) + at, p.E, rows);
    if (f32_out) row_max_out(p, amax, b, q0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    sa_block_kernel(const __grid_constant__ Maps maps, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = smem_layout<D>(smem_raw);
  __syncthreads();
  stamp(p, 0);
  const int f = p.flags;
  // In the product phases warpgroup 0 produces (thread 0 feeds the ring)
  // and warpgroups 1 and 2 consume; all three take attention tiles.
  const bool producer = threadIdx.x < 128;
  int k = 0;
  Ring r;  // the products' ring position, carried from phase 2 to phase 4
  ln_phase(p);
  grid_sync(g_bar, p, k);
  if (!producer)
    qkv_consume(p, sm, r, RowsOut{static_cast<bf16*>(p.qkv), 3 * p.E});
  else if (threadIdx.x == 0)
    qkv_produce(maps, p, sm, r);
  grid_sync(g_bar, p, k);
  if (!(f & kSkipAttn)) attention_phase<D>(maps, p, sm);
  grid_sync(g_bar, p, k);
  if (f & kQuant) {
    quant_attn_phase(p);
    grid_sync(g_bar, p, k);
  }
  if (!producer)
    out_consume(p, sm, r);
  else if (threadIdx.x == 0)
    out_produce(maps, p, sm, r);
  stamp_end(p);
}

template <int D>
int occupancy() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, sa_block_kernel<D>, kThreads, sa_smem_bytes(D));
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace

// x: (B, T, E) bf16 contiguous; scale, shift: (B, E) bf16 with row strides
// lds, ldh (16-byte aligned rows); w_qkv: (3E, E), w_o: (E, E), bf16, or
// int8 with flags & 1 (then s_qkv, s_o: their f32 row scales); b_qkv,
// b_o: f32; kpm: (B, T) bool or null; out: (B, T, E) bf16.  Scratch, rows
// M = B * Tp: xn (M, E) bf16 or int8, xs (M,) f32, qkv (M, 3E) bf16, attn
// (M, E) bf16 or f32, a8 (M, E) int8, as, ramax (M,) f32 (the int8 ones
// with flags & 1 only), 256-byte aligned.  stamps: (8,) u64 for a reading of the
// phases, or null.  grid: blocks the card holds at once
// (mm_sa_block_occupancy per SM; the host plan, ops/sa_variants.py:
// sa_block_plan), launched cooperatively.
extern "C" int mm_sa_block(const void* x, const void* scale, long long lds, const void* shift,
                           long long ldh, const void* w_qkv, const void* b_qkv,
                           const void* s_qkv, const void* w_o, const void* b_o, const void* s_o,
                           const void* kpm, void* out, void* xn, void* xs, void* qkv, void* attn,
                           void* a8, void* as, void* ramax, int B, int T, int Tp, int E, int H,
                           int rows,
                           int flags, float attn_scale, float eps, void* stamps, int grid,
                           void* stream) {
  if (!shape_ok(B, T, Tp, E, H, grid) || rows < 1 || B % rows)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = static_cast<const bf16*>(x);
  p.scale = static_cast<const bf16*>(scale);
  p.lds = lds;
  p.shift = static_cast<const bf16*>(shift);
  p.ldh = ldh;
  p.b_qkv = static_cast<const float*>(b_qkv);
  p.s_qkv = static_cast<const float*>(s_qkv);
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
  p.ramax = static_cast<float*>(ramax);
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.B = B;
  p.T = T;
  p.Tp = Tp;
  p.E = E;
  p.H = H;
  p.rows = rows;
  p.flags = flags;
  p.attn_scale = attn_scale;
  p.eps = eps;
  Maps m;
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!product_maps(&m, p, w_qkv, w_o) ||
      !rows_map(&m.q, bf, qkv, 3 * E, 3 * E, Tp, B, 2, 64, kRows) ||
      !rows_map(&m.k, bf, qkv, 3 * E, 3 * E, Tp, B, 2, 64, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  m.v = m.k;
  const int D = E / H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch(sa_block_kernel<64>, m, p, grid, sa_smem_bytes(64), s)
                 : launch(sa_block_kernel<128>, m, p, grid, sa_smem_bytes(128), s);
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
  cudaError_t e = cudaFuncSetAttribute(sa_block_kernel<64>, attr, sa_smem_bytes(64));
  if (e == cudaSuccess) e = cudaFuncSetAttribute(sa_block_kernel<128>, attr, sa_smem_bytes(128));
  return static_cast<int>(e);
}
