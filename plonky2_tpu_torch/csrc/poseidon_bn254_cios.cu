// Poseidon-BN254 permutation (width 4, x^5, 8 full + 56 partial rounds) for
// Hopper (sm_90a): the CIOS variant, a group of four threads per lane, on
// 29-bit limbs with 64-bit column sums.
//
// Replaces the Pallas TPU kernel plonky2_tpu/kernels/poseidon_bn254_pallas.py
// (permute / permute_lanes -> _kernel, with _multi_cios, _exp5_ark, _carry and
// _cond_sub), which ran the permutation on the TPU's vector units with 16-bit
// limbs in 32-bit columns, carries deferred, and fused multi-product
// Montgomery passes.  The port selects it with PLONKY2_TPU_PB_IMPL=cios;
// kernel A (poseidon_bn254.cu) is the default.  Canonical Montgomery state
// in, canonical state out, bit-exact with the torch plain version
// (hash/poseidon_bn254.permute_plain).
//
// What bounds it on the H100: 32-bit integer multiply-adds (IMAD, 64 a clock
// on each of the 132 SMs); a lane reads and writes 1 KB, which is negligible
// beside that.  The main path launches it at 7168 lanes (51 launches a step
// batch: leaf scans and FRI layers) and at 28672 (12: the Merkle levels of
// four oracles at once).  One thread a lane leaves 7168 lanes at 1.7 warps an
// SM, so there the time is one thread's chain of dependent operations; at
// 28672 lanes the card has the warps to hide latency, and the work counts.
//
// The design:
// - the TPU kernel's idea at the GPU's widths: a field element is 9 limbs
//   of 29 bits, and a product sums a_i b_j (< 2^58) into 17 64-bit columns,
//   each term one IMAD.WIDE (32 x 32 + 64 bits) with no carry between
//   columns; a Montgomery reduction by R' = 2^261 then runs limb by limb,
//   and one carry pass normalises the result.  Products of 32-bit words
//   (CIOS rows of 64-bit multiply-adds) cost 4 to 5 instructions a word
//   product, most of them carry handling, in one long dependent chain
//   (PERF.md, §6);
// - R' = 2^261 leaves so much room above p (p / R' < 0.006) that no value
//   needs a conditional subtraction until the end: a product of a and b is
//   below a b / R' + p.  The kernel's domain is x R' mod p: the input's
//   Montgomery form (R = 2^256) times 32, a shift; the constants arrive as
//   c 32 mod p (kernels/poseidon_bn254_cios.const_limbs); at the end one
//   product by 2^256 mod p divides by 32, and one subtraction of p makes the
//   value canonical;
// - two kernels, chosen at each launch by the lane count.  While one thread
//   a lane would give the card's SMs fewer than two warps each (below 8448
//   lanes on the H100), a group of G = 4 threads owns a lane (the group
//   kernel): more warps and a shorter chain a lane.  Above that, one thread
//   owns a lane (the lane kernel): the group repeats the partial rounds'
//   S-box on all four threads, so it issues about twice the products a
//   lane, which the larger launches pay for.  Measured on the H100 (PERF.md,
//   §6): at 7168 lanes the group kernel is faster, at 28672 the lane kernel;
// - the group kernel: thread e holds state element e; 32 lanes (128 threads) a
//   block, so 7168 lanes are 224 blocks, 6.8 warps an SM.  Full round: each
//   thread computes its own element's S-box, the group exchanges the four
//   results (__shfl_sync within the group) and thread i computes output i
//   of the linear layer as one pass, four products into the same columns
//   and one reduction.  Partial round: every thread computes y = s0^5 + c
//   itself (the threads of a warp issue together, so a lone thread would
//   cost the same), then thread j computes row_j s_j (s_0 = y) and, for
//   j > 0, s_j + y col_j; the four row terms are summed by two shuffle-xor
//   steps on the limbs and one carry pass, so every thread holds the new
//   s0.  Thread e reads and writes only its element's 16 limbs (128
//   contiguous bytes); lanes past n repeat lane n - 1 and store nothing, so
//   every group takes part in the shuffles;
// - the lane kernel: the same rounds on one thread, a linear-layer output and a
//   partial round's new s0 each one pass of four products; 128 lanes a
//   block.  Its S-box is a call (__noinline__): nvcc 12.9's front end
//   (cicc) crashed compiling the kernel with every S-box inlined;
// - x^2 and x^4 are squarings: 45 column products, the cross terms once by
//   2 a_i;
// - the 516 round constants (18.6 KB as limbs) are copied into shared memory
//   once a block; in the group kernel the four threads of a group read four
//   elements 9 words apart, four banks, no conflict.
//
// Exactness (tests/test_torch_cios_words.py models the limbs of both
// kernels and asserts each bound; p < 2^261 / 169):
// - every operand of a product has limbs below 2^29, so a_i b_j < 2^58; a
//   column takes at most 9 terms of a product and 9 of the reduction's m p,
//   below 18 * 2^58 + 2^36 < 2^63; a pass of four products and the
//   reduction, 45 terms, below 45 * 2^58 + 2^36 < 2^64; a squaring's
//   doubled terms (2 a_i) a_j < 2^59 take the place of two terms each;
// - a product's value (a b + m p) / 2^261 < a b / 2^261 + p with
//   m < 2^261; additive terms (a round constant, s_j) join the columns
//   before the carry pass;
// - the state stays below 58p < 2^260: the input times 32 plus ark0 is
//   below 33p; an S-box's output below 1.3p, plus c below 2.3p; a
//   linear-layer output below 1.08p; a partial round's row terms below
//   1.35p each, so s0 < 5.1p; s_j (j > 0) grows by y col_j < 1.02p a
//   partial round, from below 1.08p to below 58p; so the top limb of a
//   normalised value fits 29 bits;
// - the group kernel's four row terms' limb sums are below 2^31 before their
//   carry pass;
// - the output: the state (< 1.08p) times 2^256 mod p over 2^261 is below
//   1.01p, and one subtraction of p makes it canonical.
//
// What still holds it back (PERF.md, §6): each partial round's S-box is
// three dependent products, and 56 of the 64 rounds are partial.  At 7168
// lanes a group's chain sets the time, most of it the reductions' limb by
// limb steps and the carry passes, which are serial; at 28672 lanes the
// lane kernel holds 254 registers, so an SM runs 8 warps.
//
// The permutations and their arithmetic live in poseidon_bn254_cios.cuh,
// shared with FRI's chain kernel (fri_merkle.cu); this file keeps the two
// single-permutation kernels and their C entry.
//
// ptxas -v (sm_90a, nvcc 12.9, printed by chip_smoke.py on the H100): the
// group kernel 80 registers (79 since the header), no spills; the lane kernel 254 registers, an
// 8-byte stack frame, 8 bytes of spill stores and loads; each 18,576 bytes
// of static shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "poseidon_bn254_cios.cuh"

namespace {

using namespace pb_cios;

__global__ void __launch_bounds__(THREADS)
poseidon_bn254_cios_kernel_group(const long long* __restrict__ in,
                                 long long* __restrict__ out,
                                 const u32* __restrict__ consts, int n) {
  __shared__ __align__(16) u32 kC[N_CONST * NL];
  load_consts(kC, consts);

  const int e = threadIdx.x % G;
  const int want = blockIdx.x * LANES + threadIdx.x / G;
  const int lane = min(want, n - 1);
  const Fl s = permute_group(to_domain(in + ((size_t)lane * WIDTH + e) * 16), kC, e);
  if (want < n) store_element(out + ((size_t)lane * WIDTH + e) * 16, s);
}

__global__ void __launch_bounds__(LANE_THREADS)
poseidon_bn254_cios_kernel_lane(const long long* __restrict__ in,
                                long long* __restrict__ out,
                                const u32* __restrict__ consts, int n) {
  __shared__ __align__(16) u32 kC[N_CONST * NL];
  load_consts(kC, consts);

  const int lane = blockIdx.x * LANE_THREADS + threadIdx.x;
  if (lane >= n) return;
  Fl s[WIDTH];
#pragma unroll
  for (int e = 0; e < WIDTH; ++e) s[e] = to_domain(in + ((size_t)lane * WIDTH + e) * 16);
  permute_lane(s, kC);
#pragma unroll
  for (int e = 0; e < WIDTH; ++e)
    store_element(out + ((size_t)lane * WIDTH + e) * 16, s[e]);
}

}  // namespace

extern "C" int p2t_poseidon_bn254_cios_n_const() { return N_CONST; }

// in, out: (n, 4, 16) int64 Montgomery limbs, contiguous, on the device.
// consts: N_CONST x 9 u32, each element c of kernels/poseidon_bn254
// .const_elements as the 29-bit limbs of c 32 mod p, on the device, 16-byte
// aligned.  Returns the first CUDA error, else 0.
extern "C" int p2t_poseidon_bn254_cios_permute(const void* in, void* out,
                                               const void* consts, int n,
                                               void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if ((long long)n < (long long)GROUP_BELOW * sms)
    poseidon_bn254_cios_kernel_group<<<(n + LANES - 1) / LANES, THREADS, 0, st>>>(
        (const long long*)in, (long long*)out, (const u32*)consts, n);
  else
    poseidon_bn254_cios_kernel_lane<<<(n + LANE_THREADS - 1) / LANE_THREADS,
                                      LANE_THREADS, 0, st>>>(
        (const long long*)in, (long long*)out, (const u32*)consts, n);
  return (int)cudaGetLastError();
}
