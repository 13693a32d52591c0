// quant_rows: symmetric int8 quantisation with one f32 scale per row,
// s = max(max|x|, 1e-8) / 127, x8 = clip(rint(x / s), -127, 127), of a bf16
// or f32 (rows, K) matrix.
//
// Replaces _quant_act (mixermdm_tpu/ops/fused_block.py:58), the per-token
// activation quantisation inside the q8 Pallas block kernels
// (_sa_block_kernel_q8, _ca_block_kernel_q8, _ffn_kernel_q8): of the
// modulated input before Q/K/V and FFN1, of the attention output before the
// output projection, of the f32 FFN hidden before FFN2.  It reads each row
// twice (the second pass hits L1/L2) and writes it once in a quarter or an
// eighth of the bytes, so on an H100 it is bound by device-memory bytes.
// One warp owns one row and moves 16 bytes per lane per load.
//
// The arithmetic is the JAX package's bit for bit: the maximum is exact in
// any order, x / s is an IEEE division (the build has no --use_fast_math,
// and no reciprocal is taken: either could flip an int8 value) and rintf
// rounds half to even like jnp.round.
#include "common.cuh"

using mm::bf16;

namespace {

constexpr int kThreads = 256;  // 8 rows per block

// The V = 16 / sizeof(T) elements at x[c..c+V) as floats.
template <bool F32>
__device__ __forceinline__ void load16(const void* row, int c, float* f) {
  if (F32) {
    const float4 v = *reinterpret_cast<const float4*>(static_cast<const float*>(row) + c);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else {
    mm::unpack_bf16x8(*reinterpret_cast<const uint4*>(static_cast<const bf16*>(row) + c), f);
  }
}

__device__ __forceinline__ uint32_t q8(float v, float s) {
  const float r = fminf(fmaxf(rintf(v / s), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
}

template <bool F32>
__global__ void __launch_bounds__(kThreads)
    quant_rows_kernel(const void* __restrict__ x, int8_t* __restrict__ x8,
                      float* __restrict__ scale, int rows, int K) {
  constexpr int V = F32 ? 4 : 8;
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const void* xr = F32 ? static_cast<const void*>(static_cast<const float*>(x) + (size_t)row * K)
                       : static_cast<const void*>(static_cast<const bf16*>(x) + (size_t)row * K);
  int8_t* yr = x8 + (size_t)row * K;

  float f[V];
  float amax = 0.f;
  for (int c = lane * V; c < K; c += 32 * V) {
    load16<F32>(xr, c, f);
#pragma unroll
    for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(f[i]));
  }
  const float s = fmaxf(mm::warp_max(amax), 1e-8f) / 127.f;
  for (int c = lane * V; c < K; c += 32 * V) {
    load16<F32>(xr, c, f);
    uint32_t w[V / 4];
#pragma unroll
    for (int j = 0; j < V / 4; ++j)
      w[j] = q8(f[4 * j], s) | (q8(f[4 * j + 1], s) << 8) | (q8(f[4 * j + 2], s) << 16) |
             (q8(f[4 * j + 3], s) << 24);
    if (F32)
      *reinterpret_cast<uint32_t*>(yr + c) = w[0];
    else
      *reinterpret_cast<uint2*>(yr + c) = make_uint2(w[0], w[V / 4 - 1]);
  }
  if (lane == 0) scale[row] = s;
}

}  // namespace

// x: (rows, K) contiguous, bf16 (x_f32 == 0) or f32; x8: (rows, K) int8;
// scale: (rows,) f32.  K % 16 == 0 and 16-byte aligned pointers (checked by
// the Python wrapper).
extern "C" int mm_quant_rows(const void* x, int x_f32, void* x8, void* scale, int rows, int K,
                             void* stream) {
  const int blocks = (rows * 32 + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* yp = static_cast<int8_t*>(x8);
  float* sp = static_cast<float*>(scale);
  if (x_f32)
    quant_rows_kernel<true><<<blocks, kThreads, 0, s>>>(x, yp, sp, rows, K);
  else
    quant_rows_kernel<false><<<blocks, kThreads, 0, s>>>(x, yp, sp, rows, K);
  return static_cast<int>(cudaGetLastError());
}
