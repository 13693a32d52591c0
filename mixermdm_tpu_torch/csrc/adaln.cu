// adaln_modulate: affine-free LayerNorm (f32 statistics) followed by the
// per-batch AdaLN modulation, y = LN(x) * (1 + scale[b]) + shift[b]; and
// adaln_modulate_q8, the same rows quantised for the W8A8 products.
//
// Replaces the LN + modulation prologue of the Pallas block kernels
// (mixermdm_tpu/ops/fused_block.py: _ln and the modulation in
// _sa_block_kernel :92-94, _ca_block_kernel, _ffn_kernel :443-450) and, in
// the q8 form, the _quant_act that follows it in _sa_block_kernel_q8,
// _ca_block_kernel_q8 and _ffn_kernel_q8: the TPU kernel modulates and
// quantises in one program, and so does adaln_modulate_q8, which writes what
// _qdot8 reads (int8 rows, one f32 scale per row) without the bf16 rows ever
// reaching device memory.
//
// What bounds it on an H100: device-memory bytes (3.35 TB/s), each row read
// once and written once.  The design keeps enough bytes in flight for that:
// - one warp per row, instantiated on C = ceil(E / 256): each lane issues all
//   of its row's 16-byte loads up front (C of them, 4 at E = 1024) and holds
//   the row in registers; mean, variance and the write work from there, so
//   no pass re-reads the row;
// - 8 rows (warps) per block, all of one batch item: the block copies that
//   item's scale and shift rows into shared memory once, while its x loads
//   are in flight; scale and shift may be strided views (the two halves of
//   the modulation's (B, 2E) output), so nothing is copied on the host;
// - grid (ceil(T / 8), B): at the main path's (8, 299) that is 304 blocks
//   of 8 warps, ~2.3 per SM, all resident at once on 132 SMs, so every row
//   of the call (4.9 MB at E = 1024) is in flight in one wave.
//
// Numerics: f32 statistics, each lane summing its columns in order (chunk
// by chunk, 8 per chunk), the lanes' partials added by xor butterflies 16,
// 8, 4, 2, 1, squares accumulated by FMA, rstd = rsqrtf(var + eps), then
// ((x - mean) * rstd) * (1 + scale) + shift by one FMA and one bf16
// rounding.  The plain version in ops/adaln.py takes torch's reductions and
// rsqrt, so the two agree to a bf16 rounding, not bit for bit.  The q8 form
// quantises exactly these bf16 values with quant_rows' arithmetic (s =
// max(amax, 1e-8) / 127, rint(v / s) with an IEEE division, clamp +-127:
// mm::q8), so its output is the bits of quant_rows(adaln_modulate(...)).
#include "common.cuh"

using mm::bf16;

namespace {

constexpr int kRowsPerBlock = 8;  // one row per warp
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kMaxChunks = 4;     // E <= 1024

// Lane l holds chunk c (8 elements) at columns 256 c + 8 l; a chunk past E
// takes no part in the statistics or the write.
template <int C, bool kQ8>
__global__ void __launch_bounds__(kThreads, 3)
    adaln_modulate_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale, long long lds,
                          const bf16* __restrict__ shift, long long ldh, void* __restrict__ y,
                          float* __restrict__ row_scale, int T, int E, float eps) {
  __shared__ __align__(16) bf16 s_scale[256 * kMaxChunks], s_shift[256 * kMaxChunks];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const size_t row = (size_t)b * T + t;
  const bool live = t < T;

  // The row's loads first, so they are in flight while the block copies
  // scale and shift.
  uint4 raw[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = 256 * c + 8 * lane;
    raw[c] = live && col < E ? *reinterpret_cast<const uint4*>(x + row * E + col)
                             : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = threadIdx.x; i < E / 8; i += kThreads) {
    reinterpret_cast<uint4*>(s_scale)[i] = reinterpret_cast<const uint4*>(scale + b * lds)[i];
    reinterpret_cast<uint4*>(s_shift)[i] = reinterpret_cast<const uint4*>(shift + b * ldh)[i];
  }
  __syncthreads();
  if (!live) return;

  float f[8 * C];
#pragma unroll
  for (int c = 0; c < C; ++c) mm::unpack_bf16x8(raw[c], f + 8 * c);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 8 * C; ++i)
    if (256 * (i / 8) + 8 * lane < E) sum = __fadd_rn(sum, f[i]);
  const float fe = static_cast<float>(E);
  const float mean = __fdiv_rn(mm::warp_sum(sum), fe);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < 8 * C; ++i) {
    f[i] = __fsub_rn(f[i], mean);
    if (256 * (i / 8) + 8 * lane < E) sq = __fmaf_rn(f[i], f[i], sq);
  }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(mm::warp_sum(sq), fe), eps));

  // Modulate and round to bf16; the q8 form keeps the rounded values (as
  // floats) and their maximum magnitude for the quantisation.
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = 256 * c + 8 * lane;
    if (col >= E) continue;
    float s[8], h[8];
    mm::unpack_bf16x8(*reinterpret_cast<const uint4*>(s_scale + col), s);
    mm::unpack_bf16x8(*reinterpret_cast<const uint4*>(s_shift + col), h);
    float* m = f + 8 * c;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      m[i] = __fmaf_rn(__fmul_rn(m[i], rstd), __fadd_rn(1.f, s[i]), h[i]);
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i] = mm::pack_bf16x2(m[2 * i], m[2 * i + 1]);
      if (kQ8) {
        const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&o[i]));
        m[2 * i] = r.x;
        m[2 * i + 1] = r.y;
        amax = fmaxf(amax, fmaxf(fabsf(r.x), fabsf(r.y)));
      }
    }
    if (!kQ8) *reinterpret_cast<uint4*>(static_cast<bf16*>(y) + row * E + col) = out;
  }
  if (!kQ8) return;

  const float qs = fmaxf(mm::warp_max(amax), 1e-8f) / 127.f;
  int8_t* yr = static_cast<int8_t*>(y) + row * E;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = 256 * c + 8 * lane;
    if (col >= E) continue;
    uint32_t w[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* q = f + 8 * c + 4 * j;
      w[j] = mm::q8(q[0], qs) | (mm::q8(q[1], qs) << 8) | (mm::q8(q[2], qs) << 16) |
             (mm::q8(q[3], qs) << 24);
    }
    *reinterpret_cast<uint2*>(yr + col) = make_uint2(w[0], w[1]);
  }
  if (lane == 0) row_scale[row] = qs;
}

template <bool kQ8>
int launch(const void* x, const void* scale, long long lds, const void* shift, long long ldh,
           void* y, float* row_scale, int B, int T, int E, float eps, cudaStream_t stream) {
  if (B < 1 || T < 1 || E < 8 || E % 8 || E > 256 * kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + kRowsPerBlock - 1) / kRowsPerBlock, B);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* sp = static_cast<const bf16*>(scale);
  const bf16* hp = static_cast<const bf16*>(shift);
  switch ((E + 255) / 256) {
    case 1:
      adaln_modulate_kernel<1, kQ8><<<grid, kThreads, 0, stream>>>(xp, sp, lds, hp, ldh, y,
                                                                  row_scale, T, E, eps);
      break;
    case 2:
      adaln_modulate_kernel<2, kQ8><<<grid, kThreads, 0, stream>>>(xp, sp, lds, hp, ldh, y,
                                                                  row_scale, T, E, eps);
      break;
    case 3:
      adaln_modulate_kernel<3, kQ8><<<grid, kThreads, 0, stream>>>(xp, sp, lds, hp, ldh, y,
                                                                  row_scale, T, E, eps);
      break;
    default:
      adaln_modulate_kernel<4, kQ8><<<grid, kThreads, 0, stream>>>(xp, sp, lds, hp, ldh, y,
                                                                  row_scale, T, E, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, T, E) contiguous; scale, shift: (B, E) with row strides lds, ldh
// (elements); y: (B, T, E) bf16.  E % 8 == 0, E <= 1024, 16-byte aligned
// pointers and row strides (checked by the Python wrapper).
extern "C" int mm_adaln_modulate(const void* x, const void* scale, long long lds,
                                 const void* shift, long long ldh, void* y, int B, int T, int E,
                                 float eps, void* stream) {
  return launch<false>(x, scale, lds, shift, ldh, y, nullptr, B, T, E, eps,
                       static_cast<cudaStream_t>(stream));
}

// As mm_adaln_modulate, but y8: (B, T, E) int8 and row_scale: (B * T,) f32,
// the bf16 rows quantised as quant_rows quantises them.
extern "C" int mm_adaln_modulate_q8(const void* x, const void* scale, long long lds,
                                    const void* shift, long long ldh, void* y8, void* row_scale,
                                    int B, int T, int E, float eps, void* stream) {
  return launch<true>(x, scale, lds, shift, ldh, y8, static_cast<float*>(row_scale), B, T, E,
                      eps, static_cast<cudaStream_t>(stream));
}
