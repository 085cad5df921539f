// BN254 scalar-field arithmetic on 8 x 32-bit words for kernel A
// (poseidon_bn254.cu): Montgomery products and reductions (R = 2^256) as CIOS
// over 32-bit words.
//
// A CIOS row t += a b is 64-bit multiply-adds with the carry kept in the
// upper half (mac_row_wide): no carry flag, so the compiler can interleave
// independent rows; in kernel A on the H100 it ran faster than PTX
// carry-flag chains (mad.lo.cc / madc; PERF.md, §6), which this header no
// longer has.  Kernel A's call sites name the form (mont<true>), so the
// template parameter stays and admits only that form.
//
// Values are little-endian words.  An accumulator has ACC = 10 words: the 8
// of a field element and 2 above them, enough for a recombined byte-matrix
// output (below 2^269) plus m p inside a reduction.

#pragma once

#include <stdint.h>

namespace {

typedef uint32_t u32;
typedef unsigned long long u64;

constexpr int NW = 8;    // 32-bit words per field element
constexpr int ACC = 10;  // accumulator words

// -p^-1 mod 2^32
constexpr u32 kN0 = 0xefffffffu;

struct Fe {
  u32 w[NW];
};

// p, little-endian 32-bit words
__device__ __forceinline__ Fe fe_p() {
  return Fe{{0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
             0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u}};
}

__device__ __forceinline__ void zero(u32 (&t)[ACC]) {
#pragma unroll
  for (int k = 0; k < ACC; ++k) t[k] = 0;
}

// t += a * b as 64-bit multiply-adds: a b[k] + t[k] + carry < 2^64.
__device__ __forceinline__ void mac_row_wide(u32 (&t)[ACC], u32 a, const Fe& b) {
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    c += (u64)a * b.w[k] + t[k];
    t[k] = (u32)c;
    c >>= 32;
  }
  c += t[NW];
  t[NW] = (u32)c;
  t[NW + 1] += (u32)(c >> 32);
}

// One CIOS reduction: add m p so the low word is 0, then drop it.
template <bool WIDE>
__device__ __forceinline__ void reduce_step(u32 (&t)[ACC]) {
  static_assert(WIDE, "only the 64-bit multiply-add row form is left");
  const u32 m = t[0] * kN0;
  mac_row_wide(t, m, fe_p());
#pragma unroll
  for (int k = 0; k < ACC - 1; ++k) t[k] = t[k + 1];
  t[ACC - 1] = 0;
}

// t += x (x below 2^256) with the carry into the top words.
__device__ __forceinline__ void add_fold(u32 (&t)[ACC], const Fe& x) {
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    c += (u64)t[k] + x.w[k];
    t[k] = (u32)c;
    c >>= 32;
  }
  c += t[NW];
  t[NW] = (u32)c;
  t[NW + 1] += (u32)(c >> 32);
}

// The nine low words of t, if at least m, less m; else t.  Returns 8 words.
__device__ __forceinline__ Fe cond_sub(const u32 (&t)[ACC], const Fe& m) {
  Fe d;
  long long borrow = 0;  // 0 or -1
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const long long v = (long long)t[k] - (long long)m.w[k] + borrow;
    d.w[k] = (u32)v;
    borrow = v >> 32;
  }
  if ((long long)t[NW] + borrow >= 0) return d;
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = t[k];
  return r;
}

__device__ __forceinline__ Fe low(const u32 (&t)[ACC]) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = t[k];
  return r;
}

// t = x y / 2^256 + k p for x, y < 2p: below 2p (p < 0.19 * 2^256), in
// t[0..7].
template <bool WIDE>
__device__ __forceinline__ void mont(u32 (&t)[ACC], const Fe& x, const Fe& y) {
  zero(t);
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    mac_row_wide(t, x.w[i], y);
    reduce_step<WIDE>(t);
  }
}

}  // namespace
