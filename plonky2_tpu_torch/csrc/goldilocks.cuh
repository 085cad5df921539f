// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) on one u64 a value, and
// the quadratic extension F_p[X]/(X^2 - 7) over it and the extension algebra
// over that (Y^2 - 7), for the transcript kernel (poseidon_gl_transcript.cu),
// the extension-field chains (goldilocks_ext.cu) and the products and the
// interpolation scan (goldilocks_mul.cu).
//
// Every function takes canonical operands (< p) and returns a canonical
// value.  Field arithmetic is exact, so a kernel built from these is
// bit-exact with the plain torch versions (fields/goldilocks.py,
// fields/goldilocks_ext.py) however it orders its work.

#pragma once

#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr u64 P = 0xFFFFFFFF00000001ULL;
constexpr u64 EPSILON = 0xFFFFFFFFULL;  // 2^64 mod p
constexpr u64 W = 7;                     // X^2 = W in the extension
constexpr u64 DTH_ROOT = 0xFFFFFFFF00000000ULL;  // p - 1: conj(a) = (a0, DTH_ROOT a1)

__device__ __forceinline__ u64 canon(u64 x) { return x >= P ? x - P : x; }

__device__ __forceinline__ u64 gl_add(u64 a, u64 b) {
  u64 s = a + b;
  // a + b < 2p: a wrapped sum plus EPSILON stays below 2^64
  if (s < a) s += EPSILON;
  return canon(s);
}

__device__ __forceinline__ u64 gl_sub(u64 a, u64 b) {
  u64 d = a - b;
  // a < b: d = a - b + 2^64, and a - b + p = d - EPSILON, which is >= 0
  if (a < b) d -= EPSILON;
  return d;
}

// (hi, lo) 128-bit value -> canonical residue
__device__ __forceinline__ u64 reduce128(u64 lo, u64 hi) {
  u64 hi_hi = hi >> 32;
  u64 hi_lo = hi & EPSILON;
  u64 t0 = lo - hi_hi;          // lo - hi_hi * 2^96 == lo + hi_hi * (-1)
  if (lo < hi_hi) t0 -= EPSILON;  // borrow of 2^64 == EPSILON
  u64 t1 = hi_lo * EPSILON;     // hi_lo * 2^64
  u64 t2 = t0 + t1;
  if (t2 < t1) t2 += EPSILON;   // carry of 2^64
  return canon(t2);
}

__device__ __forceinline__ u64 gl_mul(u64 a, u64 b) {
  return reduce128(a * b, __umul64hi(a, b));
}

// x^(2^n)
__device__ __forceinline__ u64 gl_sqn(u64 x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = gl_mul(x, x);
  return x;
}

// x^(p-2) = x^(2^64 - 2^32 - 1), the inverse of x and 0 for 0, by an
// addition chain of 64 squarings and 9 products (square-and-multiply over
// the exponent's bits takes 63 and 62).  x_k below is x^(2^k - 1).
__device__ __forceinline__ u64 gl_inv(u64 x) {
  const u64 x2 = gl_mul(gl_mul(x, x), x);
  const u64 x3 = gl_mul(gl_mul(x2, x2), x);
  const u64 x6 = gl_mul(gl_sqn(x3, 3), x3);
  const u64 x12 = gl_mul(gl_sqn(x6, 6), x6);
  const u64 x24 = gl_mul(gl_sqn(x12, 12), x12);
  const u64 x30 = gl_mul(gl_sqn(x24, 6), x6);
  const u64 x31 = gl_mul(gl_mul(x30, x30), x);
  const u64 x32 = gl_mul(gl_mul(x31, x31), x);
  // (2^31 - 1) 2^33 + 2^32 - 1 = 2^64 - 2^32 - 1
  return gl_mul(gl_sqn(x31, 33), x32);
}

// A quadratic-extension value c0 + c1 X.
struct Qe {
  u64 c0, c1;
};

__device__ __forceinline__ Qe qe_add(Qe a, Qe b) {
  return Qe{gl_add(a.c0, b.c0), gl_add(a.c1, b.c1)};
}

// a b, with b1w = W b1 given: (a0 b0 + a1 b1w) + (a0 b1 + a1 b0) X.  A chain
// that multiplies by one b again and again computes b1w once, so each step
// waits on one product, not two.
__device__ __forceinline__ Qe qe_mul_w(Qe a, Qe b, u64 b1w) {
  return Qe{gl_add(gl_mul(a.c0, b.c0), gl_mul(a.c1, b1w)),
            gl_add(gl_mul(a.c0, b.c1), gl_mul(a.c1, b.c0))};
}

// a b = (a0 b0 + W a1 b1) + (a0 b1 + a1 b0) X
__device__ __forceinline__ Qe qe_mul(Qe a, Qe b) {
  return qe_mul_w(a, b, gl_mul(b.c1, W));
}

// a^-1 = conj(a) / N(a), conj(a) = (a0, DTH_ROOT a1), N(a) = a0^2 + W a1
// conj1, a base-field value; 0 for 0 (fields/goldilocks_ext.py inv).
__device__ __forceinline__ Qe qe_inv(Qe a) {
  const u64 conj1 = gl_mul(a.c1, DTH_ROOT);
  const u64 norm = gl_add(gl_mul(a.c0, a.c0), gl_mul(gl_mul(a.c1, conj1), W));
  const u64 norm_inv = gl_inv(norm);
  return Qe{gl_mul(a.c0, norm_inv), gl_mul(conj1, norm_inv)};
}

// An extension-algebra value a + b Y over the quadratic extension, Y^2 = W
// (fields/goldilocks_ext.py ea_*).
struct Ea {
  Qe a, b;
};

__device__ __forceinline__ Ea ea_add(Ea x, Ea y) {
  return Ea{qe_add(x.a, y.a), qe_add(x.b, y.b)};
}

// (x0 + x1 Y)(y0 + y1 Y) = (x0 y0 + W x1 y1) + (x0 y1 + x1 y0) Y
__device__ __forceinline__ Ea ea_mul(Ea x, Ea y) {
  const Qe t = qe_mul(x.b, y.b);
  return Ea{qe_add(qe_mul(x.a, y.a), Qe{gl_mul(t.c0, W), gl_mul(t.c1, W)}),
            qe_add(qe_mul(x.a, y.b), qe_mul(x.b, y.a))};
}

}  // namespace
