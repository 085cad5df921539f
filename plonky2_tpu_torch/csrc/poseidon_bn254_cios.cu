// Poseidon-BN254 permutation (width 4, x^5, 8 full + 56 partial rounds) for
// Hopper (sm_90a): the CIOS variant on 32-bit multiply-add carry chains.
//
// Replaces the Pallas TPU kernel plonky2_tpu/kernels/poseidon_bn254_pallas.py
// (permute / permute_lanes -> _kernel, with _multi_cios, _exp5_ark, _carry and
// _cond_sub), which ran the permutation on the TPU's vector units in a relaxed
// [0, 2p) domain with fused multi-product Montgomery passes.  The port selects
// it with PLONKY2_TPU_PB_IMPL=cios; kernel A (poseidon_bn254.cu) is the
// default.  Canonical Montgomery state in, canonical state out, bit-exact with
// the torch plain version (hash/poseidon_bn254.permute_plain).
//
// What bounds it on the H100: 32-bit integer multiply throughput (IMAD, 64 a
// clock on each of the 132 SMs).  One permutation is 784 256-bit products and
// 520 Montgomery reductions, each 8 x 8 words x (lo, hi) = 128 IMADs; a lane
// reads and writes 1 KB, which is negligible beside that.  Hopper has no 64-bit
// integer multiplier, so the words are 32 bits.
//
// What the design does about it:
// - one thread per permutation lane; each field element is 8 x 32-bit words
//   in registers; a Montgomery pass is CIOS over those words, each row one
//   mad.lo.cc / madc.lo.cc chain and one mad.hi.cc / madc.hi.cc chain
//   (bn254_mont.cuh, shared with kernel A);
// - relaxed domain: values stay in [0, 2p) between rounds.  A product of two
//   operands below 2p is below 2p after its reduction (p < 0.19 * 2^256), so
//   a single product needs no subtraction; one conditional subtraction of 2p
//   follows a fused pass or an added constant, and one of p ends the run;
// - fused passes: each linear-layer output sum_j M[j][i] s_j, and a partial
//   round's new s0, is one multi-product pass that shares one reduction per
//   word across its four products.  Additive terms (round constants, st[k] in
//   a partial round) are added to the accumulator after the pass, as
//   _multi_cios(extra=...) does.  Per permutation that is 520 reductions
//   instead of 784 (full round 12 + 4, partial round 3 + 1 + 3);
// - four products of operands below 2p and constants below p add up past
//   2^288 inside a pass, so the accumulator has two words above the eight;
//   the subtraction of 2p compares all nine low words;
// - the 516 round constants (16.5 KB) live in __constant__ memory, copied
//   from the wrapper's device buffer on the launch's stream; every read is
//   warp-uniform, so the constant cache broadcasts it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_mont.cuh"

namespace {

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

__constant__ u32 kC[N_CONST * NW];

__device__ __forceinline__ Fe load_const(int idx) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = kC[idx * NW + k];
  return r;
}

// t = (sum_j C[base + j stride] s_j) / 2^256 + k p: one fused pass over NP
// products of constants (< p) and state elements (< 2p); below 2.6 p.
template <int NP>
__device__ __forceinline__ void const_pass(u32 (&t)[ACC], const Fe* s, int base,
                                           int stride) {
  zero(t);
#pragma unroll
  for (int i = 0; i < NW; ++i) {
#pragma unroll
    for (int j = 0; j < NP; ++j) mac_row(t, kC[(base + j * stride) * NW + i], s[j]);
    reduce_step(t);
  }
}

// x^5 + ark for x < 2p; below 2p.
__device__ __forceinline__ Fe exp5_ark(const Fe& x, int ark) {
  u32 t[ACC];
  mont(t, x, x);
  const Fe x2 = low(t);
  mont(t, x2, x2);
  const Fe x4 = low(t);
  mont(t, x4, x);
  add_fold(t, load_const(ark));  // below 3p
  return cond_sub(t, fe_2p());
}

// out_i = sum_j M[j][i] s_j, each output one fused pass; below 2p.
__device__ __forceinline__ void mix(Fe (&s)[WIDTH], int off) {
  Fe out[WIDTH];
  u32 t[ACC];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    const_pass<WIDTH>(t, s, off + i, WIDTH);
    out[i] = cond_sub(t, fe_2p());
  }
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = out[i];
}

__global__ void __launch_bounds__(128)
poseidon_bn254_cios_kernel(const long long* __restrict__ in,
                           long long* __restrict__ out, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const long long* src = in + (size_t)lane * WIDTH * 16;
  Fe s[WIDTH];
  u32 t[ACC];
#pragma unroll
  for (int e = 0; e < WIDTH; ++e) {
    Fe x;
#pragma unroll
    for (int k = 0; k < NW; ++k)
      x.w[k] = (u32)src[e * 16 + 2 * k] | ((u32)src[e * 16 + 2 * k + 1] << 16);
    // canonical + canonical < 2p: stays in the relaxed domain
    zero(t);
    add_fold(t, x);
    add_fold(t, load_const(OFF_ARK0 + e));
    s[e] = low(t);
  }

#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r) {
#pragma unroll
    for (int e = 0; e < WIDTH; ++e) s[e] = exp5_ark(s[e], OFF_ARK_FIRST + r * WIDTH + e);
    mix(s, r == HALF_FULL - 1 ? OFF_P : OFF_M);
  }

#pragma unroll 1
  for (int r = 0; r < PARTIAL; ++r) {
    s[0] = exp5_ark(s[0], OFF_PART_C + r);
    const_pass<WIDTH>(t, s, OFF_S_ROW + r * WIDTH, 1);
    const Fe new0 = cond_sub(t, fe_2p());
#pragma unroll
    for (int k = 1; k < WIDTH; ++k) {
      // s_k + s0 * s_col[k-1]: s_k folded into the product's accumulator
      const_pass<1>(t, s, OFF_S_COL + r * (WIDTH - 1) + k - 1, 0);
      add_fold(t, s[k]);  // below 3.4p
      s[k] = cond_sub(t, fe_2p());
    }
    s[0] = new0;
  }

#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r) {
#pragma unroll
    for (int e = 0; e < WIDTH; ++e) s[e] = exp5_ark(s[e], OFF_ARK_SECOND + r * WIDTH + e);
    mix(s, OFF_M);
  }

  long long* dst = out + (size_t)lane * WIDTH * 16;
#pragma unroll
  for (int e = 0; e < WIDTH; ++e) {
    zero(t);
    add_fold(t, s[e]);
    const Fe c = cond_sub(t, fe_p());  // relaxed (< 2p) -> canonical
#pragma unroll
    for (int k = 0; k < 16; ++k)
      dst[e * 16 + k] = (long long)((c.w[k / 2] >> (16 * (k % 2))) & 0xFFFFu);
  }
}

}  // namespace

extern "C" int p2t_poseidon_bn254_cios_n_const() { return N_CONST; }

// in, out: (n, 4, 16) int64 Montgomery 16-bit limbs, contiguous, on the device.
// consts: N_CONST * 8 u32 words on the device, copied into constant memory on
// the stream before the launch.  Returns the first CUDA error, else 0.
extern "C" int p2t_poseidon_bn254_cios_permute(const void* in, void* out,
                                               const void* consts, int n,
                                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyToSymbolAsync(kC, consts, sizeof(kC), 0,
                                            cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    poseidon_bn254_cios_kernel<<<blocks, threads, 0, st>>>(
        (const long long*)in, (long long*)out, n);
  }
  return (int)cudaGetLastError();
}
