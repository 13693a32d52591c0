// f32 products on the tensor cores in three TF32 passes, shared by the f32
// attention forward (csrc/attention.cu) and backward (csrc/attention_bwd.cu).
//
// x = hi + lo, both TF32 (10-bit mantissas, cvt.rna): hi . hi + hi . lo +
// lo . hi with f32 sums carries a product to ~2^-22, f32 accuracy for the
// sums that follow (the lo . lo term is below 2^-22 of the product).
//
// The fragments are those of mma.sync m16n8k8 (row.col, tf32 in, f32 out),
// g = lane / 4, t = lane % 4:
//   A (16 x 8, row-major)  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, k x n)       b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8)             c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// An accumulator becomes the A operand of the next product without shuffles
// when its columns are taken in another order: A column t is C column 2t and
// A column t + 4 is C column 2t + 1 (a = {c0, c2, c1, c3}), so the B rows of
// that k-step are 2t and 2t + 1 of its 8 (``mma3_acc_nn``).
#pragma once

#include <stdint.h>

namespace mm {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A . B over one k8 step, 3xTF32 with B already split (hi and lo read
// from shared memory): the small terms first.
__device__ __forceinline__ void mma3_split(float* d, const uint32_t* ah, const uint32_t* al,
                                           const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// The same with B split here.
__device__ __forceinline__ void mma3(float* d, const uint32_t* ah, const uint32_t* al,
                                     const float* b) {
  uint32_t bh[2], bl[2];
  split_tf32(b[0], bh[0], bl[0]);
  split_tf32(b[1], bh[1], bl[1]);
  mma3_split(d, ah, al, bh, bl);
}

// A fragment from four floats, split.
__device__ __forceinline__ void split_a(const float (&a)[4], uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
}

// The A fragment of a 16 x 8 k-step taken from an accumulator (columns in
// the order 2t, 2t + 1 -> t, t + 4), split.
__device__ __forceinline__ void split_acc_a(const float (&c)[4], uint32_t (&ah)[4],
                                            uint32_t (&al)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  split_a(a, ah, al);
}

// O (16 x 8 NT) += V (16 x 8, an accumulator: k-step of keys k0..k0 + 7)
// . B (the 8 rows from row0 of a split [k][n] tile with rows of LD floats):
// the B rows of A columns t and t + 4 are 2t and 2t + 1 (see above).
template <int NT, int LD>
__device__ __forceinline__ void mma3_acc_nn(float (&o)[NT][4], const float (&v)[4],
                                            const float* bh, const float* bl, int row0, int g,
                                            int t) {
  uint32_t ah[4], al[4];
  split_acc_a(v, ah, al);
  const int r0 = (row0 + 2 * t) * LD + g;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int off = r0 + n * 8;
    const uint32_t h[2] = {__float_as_uint(bh[off]), __float_as_uint(bh[off + LD])};
    const uint32_t l[2] = {__float_as_uint(bl[off]), __float_as_uint(bl[off + LD])};
    mma3_split(o[n], ah, al, h, l);
  }
}

// Splits the n4 float4s at ``hi`` in place: each value becomes its TF32 hi
// part, and its lo part goes to the same offset of ``lo`` (threads tid,
// tid + nthreads, ...).  Each thread rewrites only what it read.
__device__ __forceinline__ void split_inplace(float* hi, float* lo, int n4, int tid,
                                              int nthreads) {
  for (int i = tid; i < n4; i += nthreads) {
    const float4 x = reinterpret_cast<const float4*>(hi)[i];
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    reinterpret_cast<uint4*>(hi)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

}  // namespace mm
