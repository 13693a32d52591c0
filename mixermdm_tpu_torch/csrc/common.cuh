// Shared device helpers for the port's Hopper kernels (sm_90a).
//
// Plain C interface, no PyTorch headers: each kernel file exports one
// `extern "C"` launcher that takes raw pointers and the caller's stream and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mm {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared.  src_bytes == 0 writes zeros
// (the ragged edge of a tile); the source address must still be valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cp.async.wait_group with a count known only at run time (0-7; a larger
// count waits for all but 7).
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>();
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// D += A(16x16, row) * B(16x8, col), bf16 inputs, f32 accumulate.
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats -> one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Eight bf16 (one 16-byte load) -> eight floats.
__device__ __forceinline__ void unpack_bf16x8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One value of a row quantised with scale s (quant_rows, adaln_modulate_q8):
// rint(v / s) clamped to +-127, as the low byte.  v / s is an IEEE division
// (the build has no --use_fast_math) and rintf rounds half to even, as
// jnp.round does.
__device__ __forceinline__ uint32_t q8(float v, float s) {
  const float r = fminf(fmaxf(rintf(v / s), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
}

// Whether any key of [k0, k0 + n) below Tk is unmasked (kpm_b: one batch's
// mask bytes, true = masked); the same answer in every lane of the warp.
__device__ __forceinline__ bool keys_live(const bool* kpm_b, int k0, int n, int Tk, int lane) {
  bool live = false;
  for (int i = lane; i < n; i += 32) {
    const int k = k0 + i;
    live |= k < Tk && !kpm_b[k];
  }
  return __any_sync(0xffffffffu, live);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace mm
