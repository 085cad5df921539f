// Fiat-Shamir transcript scan: the whole duplex Poseidon-Goldilocks sponge
// of a batch of proofs in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel plonky2_tpu/kernels/poseidon_gl_pallas.py
// (run_transcript_kernel -> _kernel), which ran the same scan out of VMEM
// with its linear layers as bf16 byte-matrix products on the MXU.
//
// Design: one thread per proof lane.  The 12 x u64 sponge state lives in
// registers; the thread runs the n_perms steps in order, each one
//   1. a masked overwrite of rate slots 0..7 with the pre-gathered absorb
//      block (absorb[p][j][lane], coalesced across lanes),
//   2. a width-12 Poseidon-GL permutation (x^7 S-box, 4 + 4 full rounds with
//      the small-entry circulant MDS, 22 fast partial rounds with init_mat12,
//      w_full and vs_full),
//   3. a store of the 12 state words (out[p][k][lane], coalesced).
// Goldilocks products are a*b lo/hi via __umul64hi, reduced with
// 2^64 = 2^32 - 1 and 2^96 = -1 (mod p); every value stays canonical so the
// states are bit-exact with the torch plain version and _run_transcript_jnp.
//
// What bounds it on the H100: latency.  The scan is strictly sequential
// (~125-130 permutations of ~30 rounds each) and a batch has at most a few
// hundred lanes, so at most a few warps run on a card of 132 SMs; each step
// is a dependent chain of 64-bit multiplies.  Speed is not this kernel's
// goal yet.
//
// Next step: fuse the public-input hash (a few permutations of the same
// kind, run as plain torch ops today) into this launch, and overlap the scan
// with the host-side work of the next batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int HALF_FULL = 4;
constexpr int N_PARTIAL = 22;
constexpr u64 P = 0xFFFFFFFF00000001ULL;
constexpr u64 EPSILON = 0xFFFFFFFFULL;  // 2^64 mod p

// Offsets (in u64 words) into the constant buffer, in the order the wrapper
// (kernels/poseidon_gl_transcript.py:_kernel_consts) lays them out.
constexpr int OFF_RC_FIRST = 0;                               // [4][12]
constexpr int OFF_RC_SECOND = OFF_RC_FIRST + 4 * WIDTH;       // [4][12]
constexpr int OFF_FIRST_CONST = OFF_RC_SECOND + 4 * WIDTH;    // [12]
constexpr int OFF_PART_CONST = OFF_FIRST_CONST + WIDTH;       // [22]
constexpr int OFF_INIT = OFF_PART_CONST + N_PARTIAL;          // [12 out][12 in]
constexpr int OFF_W_FULL = OFF_INIT + WIDTH * WIDTH;          // [22][12]
constexpr int OFF_VS_FULL = OFF_W_FULL + N_PARTIAL * WIDTH;   // [22][12]
constexpr int OFF_MDS = OFF_VS_FULL + N_PARTIAL * WIDTH;      // [12 out][12 in]
constexpr int N_CONST = OFF_MDS + WIDTH * WIDTH;

__device__ __forceinline__ u64 canon(u64 x) { return x >= P ? x - P : x; }

__device__ __forceinline__ u64 gl_add(u64 a, u64 b) {
  u64 s = a + b;
  // a + b < 2p: a wrapped sum plus EPSILON stays below 2^64
  if (s < a) s += EPSILON;
  return canon(s);
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

__device__ __forceinline__ u64 sbox(u64 x) {
  u64 x2 = gl_mul(x, x);
  u64 x3 = gl_mul(x, x2);
  u64 x6 = gl_mul(x3, x3);
  return gl_mul(x, x6);
}

// Circulant MDS with small entries: split each element into 32-bit halves,
// sum the halves' products exactly (< 2^42), then one 128-bit reduction.
__device__ __forceinline__ void mds(u64 s[WIDTH], const u64* __restrict__ c) {
  u64 out[WIDTH];
#pragma unroll
  for (int r = 0; r < WIDTH; ++r) {
    u64 lo_sum = 0, hi_sum = 0;
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) {
      u64 a = __ldg(c + OFF_MDS + r * WIDTH + k);
      lo_sum += a * (s[k] & EPSILON);
      hi_sum += a * (s[k] >> 32);
    }
    u64 lo = lo_sum + (hi_sum << 32);
    u64 hi = (hi_sum >> 32) + (lo < lo_sum);
    out[r] = reduce128(lo, hi);
  }
#pragma unroll
  for (int r = 0; r < WIDTH; ++r) s[r] = out[r];
}

__device__ void permute(u64 s[WIDTH], const u64* __restrict__ c) {
  for (int r = 0; r < HALF_FULL; ++r) {
#pragma unroll
    for (int k = 0; k < WIDTH; ++k)
      s[k] = sbox(gl_add(s[k], __ldg(c + OFF_RC_FIRST + r * WIDTH + k)));
    mds(s, c);
  }

  // folded first constant layer + init matrix (row/col 0 is the identity)
  u64 t[WIDTH];
#pragma unroll
  for (int k = 0; k < WIDTH; ++k) t[k] = gl_add(s[k], __ldg(c + OFF_FIRST_CONST + k));
#pragma unroll
  for (int r = 0; r < WIDTH; ++r) {
    u64 acc = 0;
#pragma unroll
    for (int k = 0; k < WIDTH; ++k)
      acc = gl_add(acc, gl_mul(t[k], __ldg(c + OFF_INIT + r * WIDTH + k)));
    s[r] = acc;
  }

  for (int r = 0; r < N_PARTIAL; ++r) {
    u64 s0 = gl_add(sbox(s[0]), __ldg(c + OFF_PART_CONST + r));
    s[0] = s0;
    // d = MDS0TO0 * s0 + sum_i rest[i] * w_hat[i]
    u64 d = 0;
#pragma unroll
    for (int k = 0; k < WIDTH; ++k)
      d = gl_add(d, gl_mul(s[k], __ldg(c + OFF_W_FULL + r * WIDTH + k)));
    // rest[i] += s0 * vs[i]
#pragma unroll
    for (int k = 1; k < WIDTH; ++k)
      s[k] = gl_add(s[k], gl_mul(s0, __ldg(c + OFF_VS_FULL + r * WIDTH + k)));
    s[0] = d;
  }

  for (int r = 0; r < HALF_FULL; ++r) {
#pragma unroll
    for (int k = 0; k < WIDTH; ++k)
      s[k] = sbox(gl_add(s[k], __ldg(c + OFF_RC_SECOND + r * WIDTH + k)));
    mds(s, c);
  }
}

__global__ void __launch_bounds__(64)
transcript_kernel(const long long* __restrict__ absorb_lo,
                  const long long* __restrict__ absorb_hi,
                  const unsigned char* __restrict__ mask,
                  const u64* __restrict__ c,
                  long long* __restrict__ out_lo, long long* __restrict__ out_hi,
                  int n_perms, int batch) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  u64 s[WIDTH];
#pragma unroll
  for (int k = 0; k < WIDTH; ++k) s[k] = 0;

  for (int p = 0; p < n_perms; ++p) {
#pragma unroll
    for (int j = 0; j < RATE; ++j) {
      if (mask[p * RATE + j]) {
        size_t i = ((size_t)p * RATE + j) * batch + lane;
        s[j] = (u64)absorb_lo[i] | ((u64)absorb_hi[i] << 32);
      }
    }
    permute(s, c);
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) {
      size_t i = ((size_t)p * WIDTH + k) * batch + lane;
      out_lo[i] = (long long)(s[k] & EPSILON);
      out_hi[i] = (long long)(s[k] >> 32);
    }
  }
}

}  // namespace

extern "C" int p2t_transcript_n_const() { return N_CONST; }

// absorb_lo/hi: (n_perms, 8, batch) int64 32-bit halves; mask: (n_perms, 8)
// uint8; consts: N_CONST u64; out_lo/hi: (n_perms, 12, batch) int64.
// Returns cudaGetLastError() after the launch.
extern "C" int p2t_transcript(const void* absorb_lo, const void* absorb_hi,
                              const void* mask, const void* consts, void* out_lo,
                              void* out_hi, int n_perms, int batch, void* stream) {
  if (n_perms > 0 && batch > 0) {
    const int threads = 64;
    const int blocks = (batch + threads - 1) / threads;
    transcript_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const long long*)absorb_lo, (const long long*)absorb_hi,
        (const unsigned char*)mask, (const u64*)consts, (long long*)out_lo,
        (long long*)out_hi, n_perms, batch);
  }
  return (int)cudaGetLastError();
}
