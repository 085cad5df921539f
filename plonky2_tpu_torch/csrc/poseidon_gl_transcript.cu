// Fiat-Shamir transcript scan: the whole duplex Poseidon-Goldilocks sponge
// of a batch of proofs in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel plonky2_tpu/kernels/poseidon_gl_pallas.py
// (run_transcript_kernel -> _kernel), which ran the same scan out of VMEM
// with its linear layers as bf16 byte-matrix products on the MXU.  Each of
// the n_perms steps is a masked overwrite of rate slots 0..7 with the
// pre-gathered absorb block, then a width-12 Poseidon-GL permutation (x^7
// S-box, 4 + 4 full rounds with the small-entry MDS matrix, 22 fast partial
// rounds with init_mat12, w_full and vs_full), then a store of the 12 state
// words.  Every value stays canonical, so the states are bit-exact with the
// torch plain version and _run_transcript_jnp.  The Goldilocks arithmetic is
// in goldilocks.cuh.
//
// The same launch also computes the public-input hash (HashNoPad, the JAX
// package's absorb scan at plonky2_tpu/hash/poseidon_gl.py:221): n inputs
// are ceil(n/8) absorb blocks from a zero state, slot s of block p taken
// where 8p + s < n, and the hash is words 0..3 of the last state
// (kernels/poseidon_gl_transcript.py hash_no_pad_kernel).
//
// What bounds it on the H100: latency.  The scan is a chain of dependent
// steps and a batch has only B ~ 256 chains for 132 SMs, so no multiply
// pipe is ever busy; the time is n_perms x D x L, with L the latency of one
// dependent Goldilocks product and D the products on the shortest critical
// path of one permutation:
//   D = 8 x 4  (a full round: x^7 in 3, then the MDS row)
//     + 0      (row 0 of the initial matrix is the identity)
//     + 22 x 3 (a partial round: d = x^7 w0 + pc w0 + rest, with x^7 w0 as
//               x^4 (x^3 w0), x w0 beside x^2 and x^3 w0 beside x^4; pc w0
//               is a constant; rest and s_k + x^7 vs_k take no longer)
//     = 98.
// This kernel's own path is 121: it multiplies s0 by the initial matrix's
// 1 and each partial round's x^7 by w0 after the S-box (8 x 4 + 1 + 22 x 4).
//
// What the design does about it:
// - one proof a group of 16 threads; thread k < 12 holds state word k, so
//   every S-box and every row of a linear layer runs in parallel.  A block
//   is one warp (two proofs), so a batch of 256 spreads over 128 SMs;
// - x^7 as x^2, then x^3 and x^4 together, then x^7: depth 3, not 4;
// - full rounds: thread k computes MDS row k from the 12 words, fetched
//   with __shfl_sync; products by the small entries are summed exactly in
//   32-bit halves and reduced once;
// - partial rounds: every thread of the group runs s0's S-box itself (the
//   lanes execute in lock-step, so the copies cost nothing), so s0 needs no
//   broadcast; the rest of d, sum_(k>0) s_k w[r][k], is summed by a
//   shuffle-xor tree in the same loop body as the S-box, which it does not
//   depend on, so the compiler interleaves the two; s_k += s0 vs[r][k]
//   follows;
// - the 946 constants (7.6 KB) are copied into shared memory when the block
//   starts (the threads of a warp read different words, which __constant__
//   memory would serialise); thread k keeps its MDS row in registers;
// - step p + 1's absorb word and mask byte are loaded before step p's
//   permutation and first read at step p + 1, so no load is waited for; each
//   state word is stored as soon as the permutation ends;
// - the round loops stay rolled: unrolled, the code ran slower on the card
//   (PERF.md, §6).
//
// gl_mul_chain_kernel is a measurement aid, on no path: one thread squares a
// value n times, each product waiting on the last, so chip_smoke.py can time
// L on the card.
//
// ptxas -v (sm_90a, nvcc 12.9, printed by chip_smoke.py on the H100):
// transcript_kernel 66 registers, no spill stores or loads, 7,568 bytes of
// shared memory, 1 barrier; gl_mul_chain_kernel 8 registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

namespace {

constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int HALF_FULL = 4;
constexpr int N_PARTIAL = 22;
constexpr int GROUP = 16;               // threads a proof
constexpr int THREADS = 32;             // a block: one warp, two proofs
constexpr int PROOFS = THREADS / GROUP;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

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

// x^7 in three dependent products
__device__ __forceinline__ u64 sbox(u64 x) {
  const u64 x2 = gl_mul(x, x);
  const u64 x3 = gl_mul(x2, x);
  const u64 x4 = gl_mul(x2, x2);
  return gl_mul(x3, x4);
}

__device__ __forceinline__ u64 word(u64 x, int j) {
  return __shfl_sync(FULL_MASK, x, j, GROUP);
}

// The sum of v over the 16 threads of the group, in every thread.
__device__ __forceinline__ u64 group_sum(u64 v) {
#pragma unroll
  for (int off = GROUP / 2; off > 0; off /= 2)
    v = gl_add(v, __shfl_xor_sync(FULL_MASK, v, off, GROUP));
  return v;
}

// Full round's linear layer, row k: sum_j mds[k][j] x_j with small entries,
// summed exactly in 32-bit halves (< 2^42 each) and reduced once.
__device__ __forceinline__ u64 mds_row(u64 x, const unsigned (&mds)[WIDTH]) {
  u64 lo_sum = 0, hi_sum = 0;
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) {
    const u64 xj = word(x, j);
    lo_sum += (u64)mds[j] * (xj & EPSILON);
    hi_sum += (u64)mds[j] * (xj >> 32);
  }
  const u64 lo = lo_sum + (hi_sum << 32);
  const u64 hi = (hi_sum >> 32) + (lo < lo_sum);
  return reduce128(lo, hi);
}

// One permutation of the group's state; x is word k of the thread in
// ``slot`` of its group (slots 12..15 carry a copy of word 11's arithmetic
// that nothing reads).
__device__ __forceinline__ u64 permute(u64 x, int slot, int k,
                                       const u64* __restrict__ c,
                                       const unsigned (&mds)[WIDTH]) {
#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r)
    x = mds_row(sbox(gl_add(x, c[OFF_RC_FIRST + r * WIDTH + k])), mds);

  // folded first constant layer + init matrix (row/col 0 is the identity)
  {
    const u64 t = gl_add(x, c[OFF_FIRST_CONST + k]);
    u64 prod[WIDTH];
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) prod[j] = gl_mul(word(t, j), c[OFF_INIT + k * WIDTH + j]);
#pragma unroll
    for (int step = 1; step < WIDTH; step *= 2)
#pragma unroll
      for (int j = 0; j + step < WIDTH; j += 2 * step) prod[j] = gl_add(prod[j], prod[j + step]);
    x = prod[0];
  }

  // Partial rounds, s0 in every thread.  A round's rest = sum_(k>0) s_k
  // w[r][k] needs only the state before the round, so it is summed in the
  // same loop body as the round's S-box, which it does not wait for: the
  // two chains interleave.
  const bool rest_word = slot > 0 && slot < WIDTH;
  u64 s0 = word(x, 0);
#pragma unroll 1
  for (int r = 0; r < N_PARTIAL; ++r) {
    const u64 term = gl_mul(x, c[OFF_W_FULL + r * WIDTH + k]);
    const u64 rest = group_sum(rest_word ? term : 0);
    const u64 s0n = gl_add(sbox(s0), c[OFF_PART_CONST + r]);
    // s_k += s0 vs[r][k]; slot 0 takes d after the last round
    x = gl_add(x, gl_mul(s0n, c[OFF_VS_FULL + r * WIDTH + k]));
    s0 = gl_add(gl_mul(s0n, c[OFF_W_FULL + r * WIDTH]), rest);  // d
  }
  if (slot == 0) x = s0;

#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r)
    x = mds_row(sbox(gl_add(x, c[OFF_RC_SECOND + r * WIDTH + k])), mds);
  return x;
}

__global__ void __launch_bounds__(THREADS)
transcript_kernel(const long long* __restrict__ absorb_lo,
                  const long long* __restrict__ absorb_hi,
                  const unsigned char* __restrict__ mask,
                  const u64* __restrict__ consts,
                  long long* __restrict__ out_lo, long long* __restrict__ out_hi,
                  int n_perms, int batch) {
  __shared__ u64 c[N_CONST];
  for (int q = threadIdx.x; q < N_CONST; q += THREADS) c[q] = consts[q];
  __syncthreads();

  const int slot = threadIdx.x % GROUP;
  const int k = slot < WIDTH ? slot : WIDTH - 1;
  const int lane = blockIdx.x * PROOFS + threadIdx.x / GROUP;
  const bool live = lane < batch;
  const bool stores = live && slot < WIDTH;
  const bool absorbs = live && slot < RATE;
  unsigned mds[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) mds[j] = (unsigned)c[OFF_MDS + k * WIDTH + j];

  // Step p's absorb word and mask byte, loaded a step ahead and first read at
  // step p, so no load is waited for before a permutation.
  long long next_lo = 0, next_hi = 0;
  unsigned char take = 0;
  auto absorb = [&](int p) {
    if (!absorbs) return;
    const size_t i = ((size_t)p * RATE + slot) * batch + lane;
    next_lo = absorb_lo[i];
    next_hi = absorb_hi[i];
    take = mask[p * RATE + slot];
  };
  absorb(0);
  u64 x = 0;
  for (int p = 0; p < n_perms; ++p) {
    if (take) x = (u64)next_lo | ((u64)next_hi << 32);
    take = 0;
    if (p + 1 < n_perms) absorb(p + 1);
    x = permute(x, slot, k, c, mds);
    if (stores) {
      const size_t i = ((size_t)p * WIDTH + slot) * batch + lane;
      out_lo[i] = (long long)(x & EPSILON);
      out_hi[i] = (long long)(x >> 32);
    }
  }
}

__global__ void gl_mul_chain_kernel(u64* out, u64 x, int n) {
  for (int i = 0; i < n; ++i) x = gl_mul(x, x);
  *out = x;
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
    const int blocks = (batch + PROOFS - 1) / PROOFS;
    transcript_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)absorb_lo, (const long long*)absorb_hi,
        (const unsigned char*)mask, (const u64*)consts, (long long*)out_lo,
        (long long*)out_hi, n_perms, batch);
  }
  return (int)cudaGetLastError();
}

// out: one u64 on the device, x0 squared n times in Goldilocks by one thread.
// Returns cudaGetLastError() after the launch.
extern "C" int p2t_gl_mul_chain(void* out, unsigned long long x0, int n, void* stream) {
  gl_mul_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((u64*)out, x0, n);
  return (int)cudaGetLastError();
}
