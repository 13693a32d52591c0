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
// q, k and v stay f32 out of the QKV product where they are quantised (the
// JAX kernel casts them only where it uses them in bf16; the f32 values
// cast to bf16 are the bf16 operands, written by the product's epilogue),
// and the per-sequence scales are maxima over the sequence's whole padded
// block, all E columns: Tp rows of q, k and v (the padded rows hold
// shift-valued inputs, so they count).  They are taken in the QKV
// product's epilogue, one atomicMax on the float bits per warp and row
// group, and read after the next barrier.
//
// The phases are sa_common.cuh's with two of this file's between the QKV
// product and the quantised attention output:
// - (int8 q.k^T or p.v) the int8 operands: once the maxima are known, one
//   pass reads the f32 q, k or v and writes them in the layouts TMA loads
//   and wgmma reads: q and k as int8 rows (M, E); v as int8 (B, H, D, Tv)
//   with the keys of each sequence contiguous (K-major, the only form s8
//   wgmma takes), Tv = Tp rounded up to 32, and the keys of each 32-key
//   block stored in the order in which a thread's logits arrive in the A
//   fragment (below).  The quantisations are the plain versions' (quant_v,
//   int8_attention_probs: IEEE division, rintf).  Without an int8 operand
//   the epilogue writes the bf16 projection packed, as sa_block's;
// - attention, two passes over 32-key steps per 64-row query tile of a
//   warpgroup (sa_block.cu's walk and TMA rings), because p is normalised
//   before it is quantised: pass 1 the row max (zero key included) and
//   denominator, pass 2 the logits again and p = exp(s - max) /
//   denominator, then P V.  q.k^T on wgmma m64n32k32 s8 (int32 sums,
//   exact) or m64n32k16 bf16; p.v on m64nDk32 s8 with P8 = round(127 p)
//   from registers (a thread's logits at keys 8 c + 2 t + e of a 32-key
//   step fill A-fragment positions 16 (c / 2) + 4 t + 2 (c % 2) + e, and
//   v's keys are stored in that order, so no shuffle is needed and the
//   integer sums are those of the keys in order), or on m64nDk16 bf16 with
//   P from registers and v read MN-major.  The f32 output is quantised per
//   row (quant_rows' arithmetic, the row maxima from the tiles' epilogues)
//   for the int8 out-projection, as the JAX kernel's _qdot does.
//
// What bounds it on an H100: the products' int8 tensor-core operations,
// 2 B Tp E (4E + 2 Tp) at the JAX cost estimate: 117 G at B 40, T 299,
// E 1024, 0.059 ms at 1979 TOP/s; with an int8 operand the f32 projection
// (B Tp 3E x 4 bytes, 149 MB at B 40) is written and read once more by the
// operand pass.
#include "sa_common.cuh"

namespace {

using mm::bf16;
using namespace mm::sa;

__device__ unsigned int g_bar[2];  // the grid barrier's state (sa_common.cuh)

// D(64 x N) += A(64 x 32) . B(N x 32)^T, s8 in, s32 sums, A from registers
// (each warp's 16 rows in the m16n8k32 A fragment), B K-major in shared
// memory.
template <int N>
__device__ __forceinline__ void wgmma_s8_rs(int* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_s8_rs<64>(int* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<128>(int* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The tiles of one lever set: q / k rows of D int8 (QQK) or 2D bytes, in
// slabs of up to 128 bytes (64-byte rows take the 64-byte swizzle); a K/V
// stage of 32 keys: K rows, then v as D rows of 32 int8 keys (QPV, the
// 32-byte swizzle) or 32 key rows of D bf16 in 128-byte slabs.
template <int D, bool QQK, bool QPV>
struct Tiles8 {
  static constexpr int kQkBytes = QQK ? D : 2 * D;
  static constexpr int kQkSlab = kQkBytes < 128 ? kQkBytes : 128;
  static constexpr int kQkSlabs = kQkBytes / kQkSlab;
  static constexpr int kQkSlabCols = QQK ? kQkSlab : kQkSlab / 2;  // elements
  static constexpr int kQBytes = kRows * kQkBytes;
  static constexpr int kKBytes = kKeys * kQkBytes;
  static constexpr int kVBytes = QPV ? D * kKeys : kKeys * 2 * D;
};

// The scales of sequence b: max(amax, 1e-8) / 127 of q, k, v.
__device__ __forceinline__ float seq_scale(const Params& p, int which, int b) {
  return fmaxf(__ldcg(p.amax + which * p.B + b), 1e-8f) / 127.f;
}

// The QKV product's epilogue hook: a thread's row max of |value| over its
// 32 columns of the tile, the quad's over the warp's 128 columns of one
// section (q, k or v), then one atomicMax on the float bits per warp where
// its 8 rows lie in one sequence, else one per row.
struct AmaxHook {
  unsigned int* amax;
  int B, Tp, E;
  float rmax[2] = {0.f, 0.f};
  __device__ __forceinline__ void value(int h, float v0, float v1) {
    rmax[h] = fmaxf(rmax[h], fmaxf(fabsf(v0), fabsf(v1)));
  }
  __device__ __forceinline__ void row_end(int h, int row, int n0) {
    const int t = threadIdx.x & 3, sec = n0 / E;
    float m = rmax[h];
    rmax[h] = 0.f;
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const int seq = row < B * Tp ? row / Tp : -1;
    const int seq0 = __shfl_sync(0xffffffffu, seq, 0);
    if (__all_sync(0xffffffffu, seq == seq0)) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if ((threadIdx.x & 31) == 0 && seq0 >= 0)
        atomicMax(amax + sec * B + seq0, __float_as_uint(m));
    } else if (t == 0 && seq >= 0) {
      atomicMax(amax + sec * B + seq, __float_as_uint(m));
    }
  }
};

// Four f32 values -> the 4 bytes of their int8 quantisation with scale s.
__device__ __forceinline__ uint32_t q8x4(const float4& v, float s) {
  return mm::q8(v.x, s) | (mm::q8(v.y, s) << 8) | (mm::q8(v.z, s) << 16) | (mm::q8(v.w, s) << 24);
}

// The position of key r (0..31) of a 32-key block in the A fragment of
// s8 wgmma: r = 8 c + 2 t + e of thread t's logits -> 16 (c / 2) + 4 t +
// 2 (c % 2) + e (ops/sa_variants.py: KEY_POSITION).
__device__ __forceinline__ int key_position(int r) {
  const int c = r >> 3, t = (r >> 1) & 3, e = r & 1;
  return 16 * (c >> 1) + 4 * t + 2 * (c & 1) + e;
}

// The QKV product's output: the f32 values of the sections (q, k, v) whose
// bit is set in f32_mask (their tiles are staged in f32), and the bf16
// operands of those in bf_mask (q and k without int8 q.k^T, v without int8
// p.v: the attention's operands need no per-sequence scale then).
struct QkvOut {
  float* qkv;
  bf16 *q, *k, *v;
  int E, f32_mask, bf_mask;
  __device__ __forceinline__ bool f32(int n0) const { return (f32_mask >> (n0 / E)) & 1; }
  __device__ __forceinline__ uint4 load(int, int) const { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void store(int row, int col, uint4 val, uint4, bool is_f32) const {
    const int sec = col >= 2 * E ? 2 : col >= E ? 1 : 0;
    bf16* dst = (sec == 0 ? q : sec == 1 ? k : v) + (size_t)row * E + col - sec * E;
    if (!is_f32) {  // 8 bf16 values
      *reinterpret_cast<uint4*>(dst) = val;
      return;
    }
    *reinterpret_cast<uint4*>(qkv + (size_t)row * 3 * E + col) = val;
    if ((bf_mask >> sec) & 1) {
      const float* f = reinterpret_cast<const float*>(&val);
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(mm::pack_bf16x2(f[0], f[1]), mm::pack_bf16x2(f[2], f[3]));
    }
  }
};

// ---------------------------------------------------------------------------
// The int8 operands (every thread, once the maxima are known;
// ops/sa_variants.py: i8x_operands_plain): with QQK q and k as int8 rows,
// 8 columns a thread; with QPV v as int8 (B, H, D, Tv), one warp per
// (sequence, 32-key block, 128 columns): lane l reads columns 4 l..4 l + 3
// of the block's 32 key rows (512 coalesced bytes a row; zeros past Tp),
// gathers the 32 int8 values of each of its 4 columns in registers at
// their key positions, and writes each column's 32 bytes at once.
// ---------------------------------------------------------------------------
template <bool QQK, bool QPV>
__device__ __forceinline__ void operands_phase(const Params& p) {
  const int E = p.E, E3 = 3 * E, Tp = p.Tp, B = p.B, M = B * Tp;
  const float* qkv = static_cast<const float*>(p.qkv);
  if constexpr (QQK) {
    const int n = gridDim.x * kThreads, groups = M * (E / 8);
    int8_t* q8 = static_cast<int8_t*>(p.qop);
    int8_t* k8 = static_cast<int8_t*>(p.kop);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < groups; i += n) {
      const int m = i / (E / 8), c = (i - m * (E / 8)) * 8, b = m / Tp;
      const float qs = seq_scale(p, 0, b), ks = seq_scale(p, 1, b);
      const float4* row = reinterpret_cast<const float4*>(qkv + (size_t)m * E3 + c);
      const float4 q0 = __ldcg(row), q1 = __ldcg(row + 1);
      const float4 k0 = __ldcg(row + E / 4), k1 = __ldcg(row + E / 4 + 1);
      *reinterpret_cast<uint2*>(q8 + (size_t)m * E + c) = make_uint2(q8x4(q0, qs), q8x4(q1, qs));
      *reinterpret_cast<uint2*>(k8 + (size_t)m * E + c) = make_uint2(q8x4(k0, ks), q8x4(k1, ks));
    }
  }
  if constexpr (QPV) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int H = p.H, D = E / H, Tv = p.Tv, KB = Tv / 32, CB = E / 128;
    const int items = B * KB * CB;
    int8_t* v8 = static_cast<int8_t*>(p.vop);
    for (int it = blockIdx.x * kWarps + warp; it < items; it += gridDim.x * kWarps) {
      const int cb = it % CB, kb = (it / CB) % KB, b = it / (CB * KB);
      const int col = cb * 128 + 4 * lane;
      const float vs = seq_scale(p, 2, b);
      const float* src = qkv + ((size_t)b * Tp + kb * 32) * E3 + 2 * E + col;
      uint32_t w[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) w[i][k] = 0u;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kb * 32 + r < Tp) v = __ldcg(reinterpret_cast<const float4*>(src + (size_t)r * E3));
        const uint32_t q = q8x4(v, vs);
        const int pos = key_position(r);
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i][pos >> 2] |= ((q >> (8 * i)) & 0xffu) << (8 * (pos & 3));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = (col + i) / D, d = (col + i) - h * D;
        uint4* dst = reinterpret_cast<uint4*>(v8 + ((size_t)(b * H + h) * D + d) * Tv + kb * 32);
        dst[0] = make_uint4(w[i][0], w[i][1], w[i][2], w[i][3]);
        dst[1] = make_uint4(w[i][4], w[i][5], w[i][6], w[i][7]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Attention
// ---------------------------------------------------------------------------

// The biased logits of a warpgroup's 64 rows and the 32 keys k0.. of one
// K stage: s[4 c + e] at row g + 8 (e / 2) of the warp's 16, key k0 + 8 c +
// 2 t + e % 2.  QQK: float(q8 . k8) * (qs ks scale) + bias, else the bf16
// product's f32 sum * scale + bias (each step rounded on its own).
template <int D, bool QQK>
__device__ __forceinline__ void i8x_logits(uint32_t sQ, uint32_t sK, float qk_scale,
                                           const bool* kpm_b, int T, int Tp, int k0, float* s) {
  using T8 = Tiles8<D, QQK, false>;
  using Acc = typename std::conditional<QQK, int, float>::type;
  const int t = threadIdx.x & 3;
  Acc acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T8::kQkBytes / 32; ++kk) {
    const int slab = kk * 32 / T8::kQkSlab, off = (kk * 32 % T8::kQkSlab) >> 4;
    const uint64_t da = kdesc_s(opaque(sQ) + slab * kRows * T8::kQkSlab, T8::kQkSlab) + off;
    const uint64_t db = kdesc_s(opaque(sK) + slab * kKeys * T8::kQkSlab, T8::kQkSlab) + off;
    wgmma_n32(acc, da, db, kk != 0);
  }
  sm90::wgmma_commit();
  const uint32_t mask = key_mask(kpm_b, T, k0, t);  // while it runs
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 16; ++i) sm90::reg_fence(acc[i]);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float bias = key_bias(mask, i, k0, t, T, Tp);
    if constexpr (QQK)
      s[i] = __fadd_rn(__fmul_rn(static_cast<float>(acc[i]), qk_scale), bias);
    else
      s[i] = __fadd_rn(__fmul_rn(acc[i], qk_scale), bias);
  }
}

// The attention phase, every warpgroup of the block (sa_block.cu's walk and
// loads): per tile, pass 1's K stages (loads 0 .. nkv - 1 of the tile) for
// each row's max and denominator, then pass 2's K and V stages (loads
// nkv .. 2 nkv - 1): p = exp(s - max) / denominator, then P V.
template <int D, bool QQK, bool QPV>
__device__ __forceinline__ void i8x_attention(const Maps& maps, const Params& p, const Smem& sm) {
  using T8 = Tiles8<D, QQK, QPV>;
  constexpr int S = attn_stages(D);
  const int w = threadIdx.x >> 7, tid = threadIdx.x & 127, t = threadIdx.x & 3;
  const Walk walk(p, w * gridDim.x + blockIdx.x);
  const int nkv = (p.Tp + kKeys - 1) / kKeys, L = 2 * nkv, nt = walk.count(), loads = nt * L;
  uint8_t* q_tile = sm.q_tile<D>(w);
  uint8_t* kv0 = sm.kv_stage<D>(w, 0);
  uint64_t* qbar = sm.qfull(w);
  uint64_t* fbar = sm.kvfull(w);
  const uint32_t sQ = mm::smem_u32(q_tile), sKV = mm::smem_u32(kv0);
  auto issue_q = [&](int n) {
    int b, h, q0;
    walk.tile(n, b, h, q0);
    sm90::mbar_expect_tx(qbar, T8::kQBytes);
#pragma unroll
    for (int s = 0; s < T8::kQkSlabs; ++s)
      sm90::tma_load_3d(q_tile + s * kRows * T8::kQkSlab, &maps.q, qbar,
                        h * D + s * T8::kQkSlabCols, q0, b);
  };
  auto issue_kv = [&](int i) {
    int b, h, q0;
    walk.tile(i / L, b, h, q0);
    const int x = i % L, j = x < nkv ? x : x - nkv, st = i % S;
    const bool with_v = x >= nkv;
    uint8_t* dst = kv0 + st * kv_stage_bytes(D);
    sm90::mbar_expect_tx(&fbar[st], T8::kKBytes + (with_v ? T8::kVBytes : 0));
#pragma unroll
    for (int s = 0; s < T8::kQkSlabs; ++s)
      sm90::tma_load_3d(dst + s * kKeys * T8::kQkSlab, &maps.k, &fbar[st],
                        h * D + s * T8::kQkSlabCols, j * kKeys, b);
    if (with_v) {
      uint8_t* sv = dst + kv_stage_bytes(D) / 2;
      if constexpr (QPV) {
        sm90::tma_load_2d(sv, &maps.v, &fbar[st], j * kKeys, (b * p.H + h) * D);
      } else {
#pragma unroll
        for (int s = 0; s < D / 64; ++s)
          sm90::tma_load_3d(sv + s * kKvBoxBytes, &maps.v, &fbar[st], h * D + 64 * s, j * kKeys,
                            b);
      }
    }
  };
  if (tid == 0 && nt > 0) {
    issue_q(0);
    for (int i = 0; i < min(S, loads); ++i) issue_kv(i);
  }
  using OAcc = typename std::conditional<QPV, int, float>::type;
  for (int n = 0; n < nt; ++n) {
    int b, h, q0;
    walk.tile(n, b, h, q0);
    const bool* kpm_b = p.kpm != nullptr ? p.kpm + (size_t)b * p.T : nullptr;
    const float qk_scale =
        QQK ? __fmul_rn(__fmul_rn(seq_scale(p, 0, b), seq_scale(p, 1, b)), p.attn_scale)
            : p.attn_scale;
    sm90::mbar_wait(qbar, n & 1);
    int i = n * L;

    // Pass 1: each row's max (the zero key's 0 included) and denominator.
    Online st;
    st.start(p.flags & kZeroAttn, t);
    for (int j = 0; j < nkv; ++j, ++i) {
      const int sg = i % S;
      sm90::mbar_wait(&fbar[sg], (i / S) & 1);
      float s[16];
      i8x_logits<D, QQK>(sQ, sKV + sg * kv_stage_bytes(D), qk_scale, kpm_b, p.T, p.Tp,
                         j * kKeys, s);
      sm90::named_sync(1 + w);  // the stage is free
      if (tid == 0 && i + S < loads) issue_kv(i + S);
      float mref[2], alpha[2];
      st.update(s, mref, alpha);
#pragma unroll
      for (int e = 0; e < 16; ++e) st.l[(e >> 1) & 1] += ex2((s[e] - mref[(e >> 1) & 1]) * kLog2e);
    }
    st.reduce();
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (st.m[r] == -INFINITY) st.m[r] = 0.f;

    // Pass 2: p = exp(s - max) / denominator, then P V.
    OAcc o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0;
    for (int j = 0; j < nkv; ++j, ++i) {
      const int sg = i % S;
      sm90::mbar_wait(&fbar[sg], (i / S) & 1);
      const uint32_t sK = sKV + sg * kv_stage_bytes(D), sV = sK + kv_stage_bytes(D) / 2;
      float s[16];
      i8x_logits<D, QQK>(sQ, sK, qk_scale, kpm_b, p.T, p.Tp, j * kKeys, s);
      if (j == nkv - 1) {  // the tile's Q is done: the next tile's
        sm90::named_sync(1 + w);
        if (tid == 0 && n + 1 < nt) issue_q(n + 1);
      }
#pragma unroll
      for (int e = 0; e < 16; ++e)
        s[e] = __fdiv_rn(ex2((s[e] - st.m[(e >> 1) & 1]) * kLog2e), st.l[(e >> 1) & 1]);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) sm90::reg_fence(o[e]);
      if constexpr (QPV) {
        // p8 = round(127 p) (p <= 1) into the s8 A fragment of the step's
        // k32: register r holds the bytes of logits (c0, e0), (c0, e0 + 1),
        // (c0 + 1, e0), (c0 + 1, e0 + 1), c0 = 2 (r / 2), e0 = 2 (r % 2).
        uint32_t a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int c0 = 2 * (r >> 1), e0 = 2 * (r & 1);
          uint32_t word = 0;
#pragma unroll
          for (int byte = 0; byte < 4; ++byte) {
            const float v = s[4 * (c0 + (byte >> 1)) + e0 + (byte & 1)];
            word |= (static_cast<uint32_t>(static_cast<int>(rintf(__fmul_rn(v, 127.f)))) & 0xffu)
                    << (8 * byte);
          }
          a[r] = word;
        }
        sm90::wgmma_fence();
        wgmma_s8_rs<D>(o, a, kdesc_s(opaque(sV), 32));
      } else {
        uint32_t pf[2][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pf[c >> 1][(c & 1) * 2 + 0] = mm::pack_bf16x2(s[4 * c + 0], s[4 * c + 1]);
          pf[c >> 1][(c & 1) * 2 + 1] = mm::pack_bf16x2(s[4 * c + 2], s[4 * c + 3]);
        }
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          sm90::wgmma_bf16_rs<D>(o, pf[kk], mndesc_s(opaque(sV) + kk * 2048, kKvBoxBytes));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < D / 2; ++e) sm90::reg_fence(o[e]);
      sm90::named_sync(1 + w);  // the stage is free
      if (tid == 0 && i + S < loads) issue_kv(i + S);
    }

    const float v_scale = seq_scale(p, 2, b) / 127.f;
    float amax[2] = {0.f, 0.f};
    auto val = [&](int c, int r, float& y0, float& y1) {
      if constexpr (QPV) {
        y0 = __fmul_rn(static_cast<float>(o[4 * c + 2 * r]), v_scale);
        y1 = __fmul_rn(static_cast<float>(o[4 * c + 2 * r + 1]), v_scale);
      } else {
        y0 = o[4 * c + 2 * r];
        y1 = o[4 * c + 2 * r + 1];
      }
      amax[r] = fmaxf(amax[r], fmaxf(fabsf(y0), fabsf(y1)));
    };
    stage_out<true, D>(sm.attn_stg<D>(w), 1 + w, val,
                       static_cast<float*>(p.attn) + ((size_t)b * p.Tp + q0) * p.E + h * D, p.E,
                       min(kRows, p.Tp - q0));
    row_max_out(p, amax, b, q0);
  }
}

// OPS: the forms with an int8 attention operand (int8 q.k^T or p.v); the
// others (the static scale alone, or none) take the instantiation without,
// so that each holds only its own attention's code and gets its own
// register allocation.
template <int D, bool OPS>
__global__ void __launch_bounds__(kThreads, 1)
    sa_block_i8x_kernel(const __grid_constant__ Maps maps, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = smem_layout<D>(smem_raw);
  __syncthreads();
  stamp(p, 0);
  const int lever = OPS ? (p.flags & kQqk ? 1 : 0) + (p.flags & kQpv ? 2 : 0) : 0;
  const bool producer = threadIdx.x < 128;  // as in sa_block.cu
  int k = 0;
  Ring r;
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < 3 * p.B; i += kThreads) p.amax[i] = 0.f;
  ln_phase(p);
  grid_sync(g_bar, p, k);

  // The projection (QkvOut), and each sequence's max |q|, |k|, |v|
  // (AmaxHook).
  if (!producer && !OPS) {
    qkv_consume(p, sm, r, RowsOut{static_cast<bf16*>(p.qop), 3 * p.E});  // packed, as sa_block's
  } else if (!producer) {
    const int qqk = p.flags & kQqk ? 3 : 0, qpv = p.flags & kQpv ? 4 : 0;
    const QkvOut out{static_cast<float*>(p.qkv),  static_cast<bf16*>(p.qop),
                     static_cast<bf16*>(p.kop),   static_cast<bf16*>(p.vop),
                     p.E,                         qqk | qpv,
                     7 & ~(qqk | qpv)};
    qkv_consume(p, sm, r, out, AmaxHook{reinterpret_cast<unsigned int*>(p.amax), p.B, p.Tp, p.E});
  } else if (threadIdx.x == 0) {
    qkv_produce(maps, p, sm, r);
  }
  grid_sync(g_bar, p, k);
  if constexpr (OPS) {
    switch (lever) {
      case 1: operands_phase<true, false>(p); break;
      case 2: operands_phase<false, true>(p); break;
      default: operands_phase<true, true>(p);
    }
    grid_sync(g_bar, p, k);
    switch (lever) {
      case 1: i8x_attention<D, true, false>(maps, p, sm); break;
      case 2: i8x_attention<D, false, true>(maps, p, sm); break;
      default: i8x_attention<D, true, true>(maps, p, sm);
    }
  } else {
    i8x_attention<D, false, false>(maps, p, sm);
  }
  grid_sync(g_bar, p, k);
  quant_attn_phase(p);
  grid_sync(g_bar, p, k);
  if (!producer)
    out_consume(p, sm, r);
  else if (threadIdx.x == 0)
    out_produce(maps, p, sm, r);
  stamp_end(p);
}

// The fewer blocks of the two instantiations at head dim D.
template <int D>
int occupancy() {
  int n = 0, n_ops = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, sa_block_i8x_kernel<D, false>, kThreads, sa_smem_bytes(D));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n_ops, sa_block_i8x_kernel<D, true>, kThreads, sa_smem_bytes(D));
  return e == cudaSuccess ? (n < n_ops ? n : n_ops) : -static_cast<int>(e);
}

}  // namespace

// As mm_sa_block (sa_block.cu) with int8 weights always (flags & 1): qkv is
// (M, 3E) f32 (with flags & (1024 | 2048) only: the sections of q and k
// with 2048, of v with 1024); amax: (3, B) f32 scratch for the
// per-sequence maxima; qop, kop: (M, E) bf16 scratch (int8 with flags &
// 2048), or without flags 1024 | 2048 qop is the
// packed (M, 3E) bf16 projection; vop: (M, E) bf16 scratch, or with flags &
// 1024 (B, E, Tv) int8, Tv = Tp rounded up to 32;
// inv_static, static_as: 1 / static_as and static_as as f32 (flags & 512);
// flags & 1024 int8 p.v, flags & 2048 int8 q.k^T.
extern "C" int mm_sa_block_i8x(const void* x, const void* scale, long long lds,
                               const void* shift, long long ldh, const void* w_qkv,
                               const void* b_qkv, const void* s_qkv, const void* w_o,
                               const void* b_o, const void* s_o, const void* kpm, void* out,
                               void* xn, void* xs, void* qkv, void* attn, void* a8, void* as,
                               void* ramax, void* amax, void* qop, void* kop, void* vop, int B,
                               int T, int Tp,
                               int E, int H, int flags, float attn_scale, float eps,
                               float inv_static, float static_as, void* stamps, int grid,
                               void* stream) {
  if (!shape_ok(B, T, Tp, E, H, grid) || !(flags & kQuant))
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
  p.amax = static_cast<float*>(amax);
  p.qop = qop;
  p.kop = kop;
  p.vop = vop;
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.B = B;
  p.T = T;
  p.Tp = Tp;
  p.Tv = (Tp + 31) / 32 * 32;
  p.E = E;
  p.H = H;
  p.rows = 1;
  p.flags = flags;
  p.attn_scale = attn_scale;
  p.eps = eps;
  p.inv_static = inv_static;
  p.static_as = static_as;
  const int D = E / H;
  const bool qqk = flags & kQqk, qpv = flags & kQpv;
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  Maps m;
  bool ok = product_maps(&m, p, w_qkv, w_o);
  // Without int8 operands the QKV product writes the bf16 projection
  // packed, (M, 3E) in qop, as sa_block's, and k and v are its columns E..
  // and 2E..
  const bool packed = !(flags & (kQqk | kQpv));
  const bf16* q16 = static_cast<const bf16*>(qop);
  if (packed)
    ok = ok && rows_map(&m.q, bf, q16, E, 3 * E, Tp, B, 2, 64, kRows) &&
         rows_map(&m.k, bf, q16 + E, E, 3 * E, Tp, B, 2, 64, kKeys) &&
         rows_map(&m.v, bf, q16 + 2 * E, E, 3 * E, Tp, B, 2, 64, kKeys);
  else if (qqk)
    ok = ok && rows_map(&m.q, u8, qop, E, E, Tp, B, 1, D < 128 ? D : 128, kRows) &&
         rows_map(&m.k, u8, kop, E, E, Tp, B, 1, D < 128 ? D : 128, kKeys);
  else
    ok = ok && rows_map(&m.q, bf, qop, E, E, Tp, B, 2, 64, kRows) &&
         rows_map(&m.k, bf, kop, E, E, Tp, B, 2, 64, kKeys);
  if (qpv) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.Tv), static_cast<cuuint64_t>(B) * E};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.Tv)};
    const cuuint32_t box[2] = {kKeys, static_cast<cuuint32_t>(D)};
    ok = ok && encode_map(&m.v, u8, vop, 2, dims, strides, box, 32);
  } else if (!packed) {
    ok = ok && rows_map(&m.v, bf, vop, E, E, Tp, B, 2, 64, kKeys);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qqk || qpv)
    return D == 64 ? launch(sa_block_i8x_kernel<64, true>, m, p, grid, sa_smem_bytes(64), s)
                   : launch(sa_block_i8x_kernel<128, true>, m, p, grid, sa_smem_bytes(128), s);
  return D == 64 ? launch(sa_block_i8x_kernel<64, false>, m, p, grid, sa_smem_bytes(64), s)
                 : launch(sa_block_i8x_kernel<128, false>, m, p, grid, sa_smem_bytes(128), s);
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
  cudaError_t e = cudaFuncSetAttribute(sa_block_i8x_kernel<64, false>, attr, sa_smem_bytes(64));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(sa_block_i8x_kernel<64, true>, attr, sa_smem_bytes(64));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(sa_block_i8x_kernel<128, false>, attr, sa_smem_bytes(128));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(sa_block_i8x_kernel<128, true>, attr, sa_smem_bytes(128));
  return static_cast<int>(e);
}
