// Poseidon-BN254 permutation (width 4, x^5, 8 full + 56 partial rounds) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel plonky2_tpu/kernels/poseidon_bn254_mxu.py
// (permute / permute_lanes -> _kernel), which computed the same permutation
// with its linear layers as exact bf16 byte-matrix products on the MXU.
//
// Design: one thread per permutation lane.  The state is 4 field elements of
// 4 x 64-bit words, held in registers for the whole permutation.  Montgomery
// multiplication (R = 2^256) is CIOS on 64-bit words with __umul64hi and
// carry-chained adds; x^5 is sqr, sqr, mul.  The linear layers are
// Montgomery products by the Montgomery-form constants, read from one device
// buffer (warp-uniform loads, served from L1).  Every value is kept
// canonical (< p), so the output is bit-exact with the torch plain version
// and with the reference's _permute_jnp.
//
// What bounds it on the H100: integer multiply throughput.  One permutation
// is ~500 256-bit Montgomery products (~16 64-bit multiply-highs each); the
// state never leaves registers and each lane reads/writes 1 KB of limbs, so
// memory is not the limit.  Lanes are independent, so a launch of
// 256 x 28 x 4 lanes fills all 132 SMs.
//
// Next steps: the linear layers as exact int8 byte-matrix products on the
// tensor cores (mma / wgmma with s32 accumulation, column sums
// < 128 * 255^2 < 2^31), as the MXU kernel does on the TPU, leaving only the
// S-box chains and one REDC per round on the CUDA cores.  Then the callers'
// loops (fri/verify.py _hash_leaves_scan and _merkle_chain; the reference's
// plonky2_tpu/fri/verify.py:52-102), one launch per absorb step and per tree
// level: capture them in a CUDA graph, or fuse each oracle's leaf scan and
// Merkle chain into one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int WIDTH = 4;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 56;

// p = 21888242871839275222246405745257275088548364400416034343698204186575808495617
__device__ __constant__ u64 kP[4] = {0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                                     0xb85045b68181585dULL, 0x30644e72e131a029ULL};
// -p^-1 mod 2^64
constexpr u64 kNInv = 0xc2e1f593efffffffULL;

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

struct Fe {
  u64 w[4];
};

__device__ __forceinline__ Fe load_const(const u64* __restrict__ c, int idx) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.w[k] = __ldg(c + 4 * idx + k);
  return r;
}

// a + b + carry_in over 64 bits; returns the sum, sets carry_out.
__device__ __forceinline__ u64 addc(u64 a, u64 b, u64& carry) {
  u64 s = a + b;
  u64 c1 = s < a;
  u64 s2 = s + carry;
  u64 c2 = s2 < s;
  carry = c1 | c2;
  return s2;
}

// a - b - borrow_in; sets borrow_out.
__device__ __forceinline__ u64 subb(u64 a, u64 b, u64& borrow) {
  u64 d = a - b;
  u64 b1 = a < b;
  u64 d2 = d - borrow;
  u64 b2 = d < borrow;
  borrow = b1 | b2;
  return d2;
}

// x < 2p -> x mod p
__device__ __forceinline__ Fe cond_sub_p(const Fe& x) {
  Fe d;
  u64 borrow = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) d.w[k] = subb(x.w[k], kP[k], borrow);
  return borrow ? x : d;
}

__device__ __forceinline__ Fe add_mod(const Fe& a, const Fe& b) {
  Fe s;
  u64 carry = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) s.w[k] = addc(a.w[k], b.w[k], carry);
  // a + b < 2p < 2^255: no carry out of the top word
  return cond_sub_p(s);
}

// Montgomery product a * b * 2^-256 mod p, canonical.  CIOS on 64-bit words.
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // t += a * b[i]
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      u64 lo = a.w[j] * b.w[i];
      u64 hi = __umul64hi(a.w[j], b.w[i]);
      lo += c;
      hi += lo < c;
      lo += t[j];
      hi += lo < t[j];
      t[j] = lo;
      c = hi;
    }
    t[4] += c;
    t[5] = t[4] < c;
    // t += m * p, then shift down one word (t[0] becomes 0)
    u64 m = t[0] * kNInv;
    u64 lo = m * kP[0];
    u64 hi = __umul64hi(m, kP[0]);
    lo += t[0];
    hi += lo < t[0];
    c = hi;
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      lo = m * kP[j];
      hi = __umul64hi(m, kP[j]);
      lo += c;
      hi += lo < c;
      lo += t[j];
      hi += lo < t[j];
      t[j - 1] = lo;
      c = hi;
    }
    t[3] = t[4] + c;
    t[4] = t[5] + (t[3] < c);
  }
  // t < 2p < 2^256, so t[4] == 0
  Fe r;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.w[k] = t[k];
  return cond_sub_p(r);
}

__device__ __forceinline__ Fe exp5(const Fe& x) {
  Fe x2 = mont_mul(x, x);
  Fe x4 = mont_mul(x2, x2);
  return mont_mul(x4, x);
}

// out_i = sum_j M[j][i] * s_j
__device__ __forceinline__ void mix(Fe s[WIDTH], const u64* __restrict__ c, int off) {
  Fe out[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    Fe acc = mont_mul(s[0], load_const(c, off + 0 * WIDTH + i));
#pragma unroll
    for (int j = 1; j < WIDTH; ++j)
      acc = add_mod(acc, mont_mul(s[j], load_const(c, off + j * WIDTH + i)));
    out[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = out[i];
}

__global__ void __launch_bounds__(128)
poseidon_bn254_kernel(const long long* __restrict__ in, long long* __restrict__ out,
                      const u64* __restrict__ c, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const long long* src = in + (size_t)lane * WIDTH * 16;
  Fe s[WIDTH];
#pragma unroll
  for (int e = 0; e < WIDTH; ++e) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long* l = src + e * 16 + 4 * k;
      s[e].w[k] = (u64)l[0] | ((u64)l[1] << 16) | ((u64)l[2] << 32) | ((u64)l[3] << 48);
    }
  }

#pragma unroll
  for (int e = 0; e < WIDTH; ++e) s[e] = add_mod(s[e], load_const(c, OFF_ARK0 + e));

  for (int r = 0; r < HALF_FULL; ++r) {
#pragma unroll
    for (int e = 0; e < WIDTH; ++e)
      s[e] = add_mod(exp5(s[e]), load_const(c, OFF_ARK_FIRST + r * WIDTH + e));
    mix(s, c, r == HALF_FULL - 1 ? OFF_P : OFF_M);
  }

  for (int r = 0; r < PARTIAL; ++r) {
    s[0] = add_mod(exp5(s[0]), load_const(c, OFF_PART_C + r));
    Fe new0 = mont_mul(s[0], load_const(c, OFF_S_ROW + r * 4 + 0));
#pragma unroll
    for (int j = 1; j < WIDTH; ++j)
      new0 = add_mod(new0, mont_mul(s[j], load_const(c, OFF_S_ROW + r * 4 + j)));
#pragma unroll
    for (int k = 1; k < WIDTH; ++k)
      s[k] = add_mod(s[k], mont_mul(s[0], load_const(c, OFF_S_COL + r * 3 + k - 1)));
    s[0] = new0;
  }

  for (int r = 0; r < HALF_FULL; ++r) {
#pragma unroll
    for (int e = 0; e < WIDTH; ++e)
      s[e] = add_mod(exp5(s[e]), load_const(c, OFF_ARK_SECOND + r * WIDTH + e));
    mix(s, c, OFF_M);
  }

  long long* dst = out + (size_t)lane * WIDTH * 16;
#pragma unroll
  for (int e = 0; e < WIDTH; ++e) {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      dst[e * 16 + k] = (long long)((s[e].w[k / 4] >> (16 * (k % 4))) & 0xFFFFULL);
  }
}

}  // namespace

extern "C" int p2t_poseidon_bn254_n_const() { return N_CONST; }

// in, out: (n, 4, 16) int64 Montgomery 16-bit limbs, contiguous, on the device.
// consts: N_CONST * 4 u64 words.  Returns cudaGetLastError() after the launch.
extern "C" int p2t_poseidon_bn254_permute(const void* in, void* out, const void* consts,
                                          int n, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    poseidon_bn254_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const long long*)in, (long long*)out, (const u64*)consts, n);
  }
  return (int)cudaGetLastError();
}
