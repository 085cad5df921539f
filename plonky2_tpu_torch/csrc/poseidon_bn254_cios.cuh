// The CIOS form's permutation (poseidon_bn254_cios.cu), shared by the
// single-permutation kernels (poseidon_bn254_cios.cu) and FRI's chain kernel
// (fri_merkle.cu, merkle_chains_cios_kernel).  The design, the domain
// (x 2^261 mod p on 9 limbs of 29 bits) and the bounds are in
// poseidon_bn254_cios.cu's header.
//
// Two forms of the permutation: permute_group on a group of G = 4 threads
// (thread e holds element e; every thread of the warp must take part, for
// the shuffles) and permute_lane on one thread.  Both take the state in the
// kernel's domain, normalised, each element below 32p (an input converted by
// to_domain, or a permutation's output, below 1.08p), add ark0 and return
// the output state, each element below 1.08p; store_element converts an
// element back to canonical 16-bit limbs.  So a chain of permutations
// converts its inputs once on entry and its result once on exit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace pb_cios {

typedef uint32_t u32;
typedef unsigned long long u64;

constexpr int WIDTH = 4;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 56;

// Offsets (in field elements) into the constant buffer, in the order the
// wrapper (kernels/poseidon_bn254.const_elements) lays them out.
constexpr int OFF_ARK0 = 0;                              // [4]
constexpr int OFF_ARK_FIRST = OFF_ARK0 + WIDTH;          // [4][4]
constexpr int OFF_ARK_SECOND = OFF_ARK_FIRST + 16;       // [4][4]
constexpr int OFF_M = OFF_ARK_SECOND + 16;               // [4 j][4 i]
constexpr int OFF_P = OFF_M + 16;                        // [4 j][4 i]
constexpr int OFF_PART_C = OFF_P + 16;                   // [56]
constexpr int OFF_S_ROW = OFF_PART_C + PARTIAL;          // [56][4]
constexpr int OFF_S_COL = OFF_S_ROW + PARTIAL * 4;       // [56][3]
constexpr int N_CONST = OFF_S_COL + PARTIAL * 3;

constexpr int NL = 9;                  // limbs an element
constexpr int LB = 29;                 // bits a limb
constexpr u32 LM = (1u << LB) - 1;
constexpr u32 kN0 = 0x0fffffffu;       // -p^-1 mod 2^29
constexpr int IN_WORDS = 8;            // 32-bit words of an input element

constexpr int G = WIDTH;               // group kernel: threads a lane
constexpr int LANES = 32;              // group kernel: lanes a block
constexpr int THREADS = G * LANES;
constexpr unsigned ALL = 0xffffffffu;  // every thread of a warp shuffles
constexpr int LANE_THREADS = 128;      // lane kernel: lanes a block
constexpr int GROUP_BELOW = 2 * 32;    // the group kernel below this many lanes an SM

struct Fl {
  u32 l[NL];
};

// 64-bit column sums: column k has weight 2^(29 k).
struct Cols {
  u64 c[2 * NL];
};

// p and 2^256 mod p in 29-bit limbs.
__device__ __forceinline__ Fl fl_p() {
  return Fl{{0x10000001u, 0x1f0fac9fu, 0x0e5c2450u, 0x07d090f3u, 0x1585d283u,
             0x02db40c0u, 0x00a6e141u, 0x0e5c2634u, 0x0030644eu}};
}
__device__ __forceinline__ Fl fl_r_mod_p() {
  return Fl{{0x0ffffffbu, 0x04b1a0e2u, 0x18334a6bu, 0x18ed2b3eu, 0x1462e36fu,
             0x11b7bc3cu, 0x1cbd99bau, 0x183340fbu, 0x000e0a77u}};
}
__device__ __forceinline__ Fl fl_zero() {
  return Fl{{0, 0, 0, 0, 0, 0, 0, 0, 0}};
}

__device__ __forceinline__ Fl load_const(const u32* c, int idx) {
  Fl r;
#pragma unroll
  for (int k = 0; k < NL; ++k) r.l[k] = c[idx * NL + k];
  return r;
}

__device__ __forceinline__ void zero(Cols& t) {
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) t.c[k] = 0;
}

// t += a b.
__device__ __forceinline__ void mul_add(Cols& t, const Fl& a, const Fl& b) {
#pragma unroll
  for (int i = 0; i < NL; ++i)
#pragma unroll
    for (int j = 0; j < NL; ++j) t.c[i + j] += (u64)a.l[i] * b.l[j];
}

// t += a^2: the cross terms once, by 2 a_i (< 2^30).
__device__ __forceinline__ void sqr_add(Cols& t, const Fl& a) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    t.c[2 * i] += (u64)a.l[i] * a.l[i];
    const u32 d = a.l[i] << 1;
#pragma unroll
    for (int j = i + 1; j < NL; ++j) t.c[i + j] += (u64)d * a.l[j];
  }
}

// (t + m p) / 2^261 + add, normalised, for the m < 2^261 that clears the low
// 261 bits: one reduction step a limb, then one carry pass.
__device__ __forceinline__ Fl redc(Cols& t, const Fl& add) {
  const Fl p = fl_p();
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const u32 m = ((u32)t.c[i] * kN0) & LM;
#pragma unroll
    for (int j = 0; j < NL; ++j) t.c[i + j] += (u64)m * p.l[j];
    t.c[i + 1] += t.c[i] >> LB;  // t.c[i] is a multiple of 2^29 now
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) t.c[NL + k] += add.l[k];
  Fl r;
#pragma unroll
  for (int k = NL; k < 2 * NL - 1; ++k) {
    t.c[k + 1] += t.c[k] >> LB;
    r.l[k - NL] = (u32)t.c[k] & LM;
  }
  r.l[NL - 1] = (u32)t.c[2 * NL - 1];
  return r;
}

// a b / 2^261 + k p + add.
__device__ __forceinline__ Fl mont(const Fl& a, const Fl& b, const Fl& add) {
  Cols t;
  zero(t);
  mul_add(t, a, b);
  return redc(t, add);
}

__device__ __forceinline__ Fl msqr(const Fl& a) {
  Cols t;
  zero(t);
  sqr_add(t, a);
  return redc(t, fl_zero());
}

// x^5 + c.
__device__ __forceinline__ Fl exp5_add(const Fl& x, const Fl& c) {
  return mont(msqr(msqr(x)), x, c);
}

// The same as a call, for the lane kernel (see the header).
__device__ __noinline__ Fl exp5_add_call(Fl x, Fl c) { return exp5_add(x, c); }

// Element x of thread src of this thread's group.
__device__ __forceinline__ Fl shfl(const Fl& x, int src) {
  Fl r;
#pragma unroll
  for (int k = 0; k < NL; ++k) r.l[k] = __shfl_sync(ALL, x.l[k], src, G);
  return r;
}

// x plus the x of the group's thread whose index differs by mask, limb by
// limb.
__device__ __forceinline__ Fl add_xor(const Fl& x, int mask) {
  Fl r;
#pragma unroll
  for (int k = 0; k < NL; ++k)
    r.l[k] = x.l[k] + __shfl_xor_sync(ALL, x.l[k], mask, G);
  return r;
}

// Limbs below 2^32 -> limbs below 2^29, the value unchanged (below 2^261).
__device__ __forceinline__ Fl carry(const Fl& x) {
  Fl r;
  u32 c = 0;
#pragma unroll
  for (int k = 0; k < NL - 1; ++k) {
    const u64 v = (u64)x.l[k] + c;
    r.l[k] = (u32)v & LM;
    c = (u32)(v >> LB);
  }
  r.l[NL - 1] = x.l[NL - 1] + c;
  return r;
}

__device__ __forceinline__ Fl select(bool c, const Fl& a, const Fl& b) {
  Fl r;
#pragma unroll
  for (int k = 0; k < NL; ++k) r.l[k] = c ? a.l[k] : b.l[k];
  return r;
}

// An input element (x 2^256 mod p as 16-bit limbs in int64) in the kernel's
// domain: x 2^261, below 32p, normalised.  Limb i of x 2^261 is bits
// 29 i - 5 .. 29 i + 23 of the input.
__device__ __forceinline__ Fl to_domain(const long long* src) {
  u32 w[IN_WORDS + 1];
#pragma unroll
  for (int k = 0; k < IN_WORDS; ++k)
    w[k] = (u32)src[2 * k] | ((u32)src[2 * k + 1] << 16);
  w[IN_WORDS] = 0;
  Fl x;
  x.l[0] = (w[0] << 5) & LM;
#pragma unroll
  for (int i = 1; i < NL; ++i) {
    const int q = LB * i - 5;
    const u64 v = (u64)w[q / 32] | ((u64)w[q / 32 + 1] << 32);
    x.l[i] = (u32)(v >> (q % 32)) & LM;
  }
  return x;
}

// x + a, normalised (limbs below 2^29 in, the sum below 2^261).
__device__ __forceinline__ Fl add(const Fl& x, const Fl& a) {
  Fl r;
#pragma unroll
  for (int k = 0; k < NL; ++k) r.l[k] = x.l[k] + a.l[k];
  return carry(r);
}

// x 2^261 (below 58p) -> canonical x 2^256 mod p as 16-bit limbs: one
// product by 2^256 mod p (below 1.01p), then at most one subtraction of p.
__device__ __forceinline__ void store_element(long long* dst, const Fl& s) {
  Fl c = mont(s, fl_r_mod_p(), fl_zero());
  const Fl p = fl_p();
  Fl d;
  u32 borrow = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const u32 v = c.l[k] - p.l[k] - borrow;
    borrow = v >> 31;  // limbs < 2^29: a borrow sets the top bit
    d.l[k] = v & LM;
  }
  if (!borrow) c = d;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int q = 16 * k, i = q / LB;
    const u64 v = (u64)c.l[i] | (i + 1 < NL ? (u64)c.l[i + 1] << LB : 0);
    dst[k] = (long long)((v >> (q % LB)) & 0xFFFFu);
  }
}

// Group kernel: the full round for this thread's element e, the S-box plus
// its constant, then output e of the linear layer sum_j M[j][e] y_j (M at
// off, [j][i]).
__device__ __forceinline__ Fl full_round(const Fl& s, const u32* c, int ark,
                                         int off, int e) {
  const Fl y = exp5_add(s, load_const(c, ark));
  Cols t;
  zero(t);
#pragma unroll
  for (int j = 0; j < WIDTH; ++j)
    mul_add(t, load_const(c, off + j * WIDTH + e), shfl(y, j));
  return redc(t, fl_zero());
}

// The permutation on a group of G threads: x is this thread's element e
// (below 32p, normalised); returns element e of the output (below 1.08p).
__device__ __forceinline__ Fl permute_group(const Fl& x, const u32* kC, int e) {
  Fl s = add(x, load_const(kC, OFF_ARK0 + e));

#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r)
    s = full_round(s, kC, OFF_ARK_FIRST + r * WIDTH + e,
                   r == HALF_FULL - 1 ? OFF_P : OFF_M, e);

  Fl s0 = shfl(s, 0);
  const int col = OFF_S_COL + (e == 0 ? 0 : e - 1);  // thread 0's is unused
#pragma unroll 1
  for (int r = 0; r < PARTIAL; ++r) {
    const Fl y = exp5_add(s0, load_const(kC, OFF_PART_C + r));
    const Fl row = mont(select(e == 0, y, s),
                        load_const(kC, OFF_S_ROW + r * WIDTH + e), fl_zero());
    s = mont(y, load_const(kC, col + r * (WIDTH - 1)), s);
    s0 = carry(add_xor(add_xor(row, 1), 2));
  }
  s = select(e == 0, s0, s);

#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r)
    s = full_round(s, kC, OFF_ARK_SECOND + r * WIDTH + e, OFF_M, e);
  return s;
}

// Lane kernel: out_i = sum_j M[j][i] y_j (M at off, [j][i]), each output one
// pass.
__device__ __forceinline__ void mix(Fl (&s)[WIDTH], const u32* c, int off) {
  Fl out[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    Cols t;
    zero(t);
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) mul_add(t, load_const(c, off + j * WIDTH + i), s[j]);
    out[i] = redc(t, fl_zero());
  }
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = out[i];
}

// The permutation on one thread: s in (each element below 32p, normalised),
// the output out (each below 1.08p).
__device__ __forceinline__ void permute_lane(Fl (&s)[WIDTH], const u32* kC) {
#pragma unroll
  for (int e = 0; e < WIDTH; ++e) s[e] = add(s[e], load_const(kC, OFF_ARK0 + e));

#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r) {
#pragma unroll
    for (int e = 0; e < WIDTH; ++e)
      s[e] = exp5_add_call(s[e], load_const(kC, OFF_ARK_FIRST + r * WIDTH + e));
    mix(s, kC, r == HALF_FULL - 1 ? OFF_P : OFF_M);
  }

#pragma unroll 1
  for (int r = 0; r < PARTIAL; ++r) {
    s[0] = exp5_add_call(s[0], load_const(kC, OFF_PART_C + r));
    Cols t;
    zero(t);
#pragma unroll
    for (int j = 0; j < WIDTH; ++j)
      mul_add(t, load_const(kC, OFF_S_ROW + r * WIDTH + j), s[j]);
#pragma unroll
    for (int k = 1; k < WIDTH; ++k)
      s[k] = mont(s[0], load_const(kC, OFF_S_COL + r * (WIDTH - 1) + k - 1), s[k]);
    s[0] = redc(t, fl_zero());
  }

#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r) {
#pragma unroll
    for (int e = 0; e < WIDTH; ++e)
      s[e] = exp5_add_call(s[e], load_const(kC, OFF_ARK_SECOND + r * WIDTH + e));
    mix(s, kC, OFF_M);
  }
}

// The constant buffer into the block's shared memory kC (N_CONST * NL
// words), then a __syncthreads.
__device__ __forceinline__ void load_consts(u32* kC, const u32* __restrict__ consts) {
  for (int q = threadIdx.x; q < N_CONST * NL / 4; q += blockDim.x)
    reinterpret_cast<uint4*>(kC)[q] = __ldg(reinterpret_cast<const uint4*>(consts) + q);
  __syncthreads();
}

}  // namespace pb_cios
}  // namespace
