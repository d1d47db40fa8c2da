// 3xTF32 products on mma.sync m16n8k8 and 16-byte cp.async, the device
// helpers of K9's chunked form (gated_delta.cu). Each float32 operand is
// split into a TF32 high part and a TF32 remainder; hi.hi + hi.lo + lo.hi
// summed in float32 carries a product to about 2^-21 relative (plain TF32
// keeps about 2^-11).

#pragma once

#include <stdint.h>

namespace {

// a float32 operand as hi + lo for 3xTF32
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// hi: x rounded to TF32's 10 mantissa bits (half an ulp added to the bit
// pattern, then the low 13 bits cleared: two integer instructions, where
// cvt.rna.tf32.f32 takes five with its inf/NaN test; the operands here
// are finite); lo = x - hi, exact, |lo| <= 2^-11 |x|, passed as is: the
// tensor core reads its top 10 mantissa bits, so hi + lo carries x to
// about 2^-21 relative
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// not volatile: the compiler may interleave independent products
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: d += a.lo b.hi + a.hi b.lo + a.hi b.hi, the small terms first
// (a.lo b.lo, about 2^-22 of the product, is left out). The three terms
// of one product depend on each other through d, so the helpers issue
// each term for all of their N independent accumulators before the next
// term: a warp then waits for no HMMA's result.
// d[n] += a[n] b[n]
template <int N>
__device__ __forceinline__ void mma3_each(float (&d)[N][4],
                                          const FragA (&a)[N],
                                          const FragB (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a[n].lo, b[n].hi);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a[n].hi, b[n].lo);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a[n].hi, b[n].hi);
}
// d[m][n] += a[m] b[n]
template <int M, int N>
__device__ __forceinline__ void mma3_grid(float (&d)[M][N][4],
                                          const FragA (&a)[M],
                                          const FragB (&b)[N]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(d[m][n], a[m].lo, b[n].hi);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(d[m][n], a[m].hi, b[n].lo);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(d[m][n], a[m].hi, b[n].hi);
}
// d[n] += a b[n]
template <int N>
__device__ __forceinline__ void mma3_row(float (&d)[N][4], const FragA& a,
                                         const FragB (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a.lo, b[n].hi);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a.hi, b[n].lo);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a.hi, b[n].hi);
}

// The m16n8k8 fragments (g = lane / 4, t = lane % 4): A rows g and g + 8,
// columns t and t + 4; B rows (k) t and t + 4, column g; C rows g and
// g + 8, columns 2t and 2t + 1.
// A tile at (m0, k0) of a row-major [m][k] array with row stride ld
__device__ __forceinline__ FragA load_a(const float* s, int ld, int m0,
                                        int k0, int lane) {
  const float* p = s + (m0 + (lane >> 2)) * ld + k0 + (lane & 3);
  FragA f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[8 * ld], f.hi[1], f.lo[1]);
  split_tf32(p[4], f.hi[2], f.lo[2]);
  split_tf32(p[8 * ld + 4], f.hi[3], f.lo[3]);
  return f;
}
// A tile at (m0, k0) of A = X^T for a row-major [k][m] array X
__device__ __forceinline__ FragA load_a_t(const float* s, int ld, int m0,
                                          int k0, int lane) {
  const float* p = s + (k0 + (lane & 3)) * ld + m0 + (lane >> 2);
  FragA f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[8], f.hi[1], f.lo[1]);
  split_tf32(p[4 * ld], f.hi[2], f.lo[2]);
  split_tf32(p[4 * ld + 8], f.hi[3], f.lo[3]);
  return f;
}
// B tile at (k0, n0) of a row-major [k][n] array, row k scaled by sc[k]
// when sc is given (one float32 rounding, as the plain version's)
__device__ __forceinline__ FragB load_b_kn(const float* s, int ld, int k0,
                                           int n0, int lane,
                                           const float* sc = nullptr) {
  const int t = lane & 3;
  const float* p = s + (k0 + t) * ld + n0 + (lane >> 2);
  float b0 = p[0], b1 = p[4 * ld];
  if (sc != nullptr) {
    b0 *= sc[k0 + t];
    b1 *= sc[k0 + t + 4];
  }
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}
// B tile at (k0, n0) of B = X^T for a row-major [n][k] array X
__device__ __forceinline__ FragB load_b_nk(const float* s, int ld, int k0,
                                           int n0, int lane) {
  const float* p = s + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
  FragB f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[4], f.hi[1], f.lo[1]);
  return f;
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 zero-fills the
// destination without reading (the source stays a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
