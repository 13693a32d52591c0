// adaln_modulate: affine-free LayerNorm (f32 statistics) followed by the
// per-batch AdaLN modulation, y = LN(x) * (1 + scale[b]) + shift[b].
//
// Replaces the LN + modulation prologue of the Pallas block kernels
// (mixermdm_tpu/ops/fused_block.py: _sa_block_kernel, _ca_block_kernel,
// _ffn_kernel).  It reads each row once and writes it once, so it is bound
// by device-memory bytes; one warp owns one row, keeps it in L1 across the
// mean / variance / write passes, and moves 16 bytes per lane per load.
#include "common.cuh"

using mm::bf16;

namespace {

constexpr int kThreads = 256;  // 8 rows per block

__global__ void __launch_bounds__(kThreads)
    adaln_modulate_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                          const bf16* __restrict__ shift, bf16* __restrict__ y, int rows,
                          int T, int E, float eps) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int b = row / T;
  const bf16* xr = x + (size_t)row * E;
  const bf16* sr = scale + (size_t)b * E;
  const bf16* hr = shift + (size_t)b * E;
  bf16* yr = y + (size_t)row * E;

  float f[8];
  float sum = 0.f;
  for (int c = lane * 8; c < E; c += 256) {
    mm::unpack_bf16x8(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += f[i];
  }
  const float mean = mm::warp_sum(sum) / E;
  float sq = 0.f;
  for (int c = lane * 8; c < E; c += 256) {
    mm::unpack_bf16x8(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) sq += (f[i] - mean) * (f[i] - mean);
  }
  const float rstd = rsqrtf(mm::warp_sum(sq) / E + eps);
  for (int c = lane * 8; c < E; c += 256) {
    float s[8], h[8];
    mm::unpack_bf16x8(*reinterpret_cast<const uint4*>(xr + c), f);
    mm::unpack_bf16x8(*reinterpret_cast<const uint4*>(sr + c), s);
    mm::unpack_bf16x8(*reinterpret_cast<const uint4*>(hr + c), h);
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = (f[2 * i] - mean) * rstd * (1.f + s[2 * i]) + h[2 * i];
      const float c2 = (f[2 * i + 1] - mean) * rstd * (1.f + s[2 * i + 1]) + h[2 * i + 1];
      o[i] = mm::pack_bf16x2(a, c2);
    }
    *reinterpret_cast<uint4*>(yr + c) = out;
  }
}

}  // namespace

// x, y: (rows, E) with rows = B * T; scale, shift: (B, E).  E % 8 == 0 and
// 16-byte aligned pointers (checked by the Python wrapper).
extern "C" int mm_adaln_modulate(const void* x, const void* scale, const void* shift, void* y,
                                 int rows, int T, int E, float eps, void* stream) {
  const int blocks = (rows * 32 + kThreads - 1) / kThreads;
  adaln_modulate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(shift), static_cast<bf16*>(y), rows, T, E, eps);
  return static_cast<int>(cudaGetLastError());
}
