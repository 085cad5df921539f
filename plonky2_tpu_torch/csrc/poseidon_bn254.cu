// Poseidon-BN254 permutation (width 4, x^5, 8 full + 56 partial rounds) for
// Hopper (sm_90a): kernel A, each round's linear layer one exact byte-matrix
// product on the int8 tensor cores.
//
// Replaces the Pallas TPU kernel plonky2_tpu/kernels/poseidon_bn254_mxu.py
// (permute / permute_lanes -> _kernel), which computed the same permutation
// with its linear layers as exact bf16 byte-matrix products on the MXU.
// Canonical Montgomery state in, canonical state out, bit-exact with the
// torch plain version (hash/poseidon_bn254.permute_plain).
//
// The idea is the TPU kernel's: multiplication by a constant is linear over
// the input's bytes, c x = sum_k x_k (c 2^(8k) mod p), so a round's whole
// linear layer out_i = sum_j c_(j,i) s_j is one product
//   [lanes x 128 u8] . [128 x 128 u8] -> s32,
// a lane's row being its 4 elements' 32 little-endian bytes, and the round's
// matrix Bt[i*32 + m][j*32 + k] = byte m of (c_(j,i) 2^(8k) mod p) (built by
// kernels/poseidon_bn254.round_matrices).  It is exact: a column sum is at
// most 128 * 255^2 < 2^23; an output's 32 columns recombine to a value below
// 128 * 255 * p < 2^15 p, for any row below 2^256; one Montgomery reduction
// by 2^256 gives a value below p + 2^13, and one subtraction of p makes it
// canonical.  The matrices hold Montgomery-form constants, so the reduction's
// 2^-256 keeps the state in Montgomery form.
//
// What bounds it on the H100: 32-bit integer multiply-adds (IMAD, 64 a clock
// on each of the 132 SMs).  The CUDA cores keep the S-boxes (264 Montgomery
// products a permutation, 176 of them the squarings x^2 and x^4) and 520
// reductions (264 of the S-boxes, 256 of the linear layers).  A product or a
// reduction is 128 IMADs, a squaring 72 (36 word products, lo and hi), so
// the function needs 90,496 IMADs a permutation in this form, against the
// CIOS form's 157,056.  The tensor-core work (64 x 128^2 byte products) is
// a fifth of the IMAD time at 1,979 TOP/s, and a lane's 1 KB of limbs less.
// This kernel squares with general products: 100,352 IMADs.
//
// The design:
// - a block owns a tile of 64 lanes, one thread each (2 warps).  64 rather
//   than 128 lanes: at the main path's largest launch (28672 lanes) that is
//   448 blocks, 4 of them (55 KB of shared memory each) resident on an SM,
//   so all are in flight at once and the SMs are evenly loaded;
// - each warp owns the 32 rows of its lanes in the A tile, so the A tile and
//   the s32 read-back need only __syncwarp; rows are padded to 144 bytes so
//   that ldmatrix, the 16-byte row stores and the read-back have no bank
//   conflicts;
// - each round: (1) CUDA cores, one lane a thread: x^5 plus the round
//   constant on the 4 elements (full round) or element 0 (partial round),
//   CIOS on 32-bit words (bn254_mont.cuh) with the rows as 64-bit
//   multiply-adds rather than PTX carry-flag chains.  With one lane a thread
//   and 28672 lanes an SM holds only ~7 warps, so the chains' latency, not
//   the IMAD rate, sets the time; the carry-flag form did not gain from
//   interleaving independent chains in the source, the 64-bit form (no carry
//   flag) ran faster (PERF.md, §6).  The result (below 3p) goes into the
//   lane's A row;
//   (2) tensor cores: mma.sync m16n8k32 u8 x u8 -> s32 per warp, one output
//   element (32 columns) at a time, A and B through ldmatrix; a partial
//   round's zero 32 x 32 blocks (out_k for k > 0 reads only s_0 and s_k) are
//   skipped; (3) the fragments go through shared memory to their lane's
//   thread, which recombines the columns, reduces and subtracts p if needed.
//   The state is canonical between rounds;
// - mma.sync rather than wgmma: the product is 64 rows by 128 by 128 a round
//   and the tensor cores are not the bound, so wgmma's asynchrony and
//   descriptors buy nothing here, and mma.sync keeps each warp's rows its own;
// - the 64 round matrices (16 KB each, 1 MB in all, L2-resident) are streamed
//   with cp.async into two shared buffers: matrix r + 1 is copied while
//   round r computes, and one __syncthreads a round hands a buffer over.
//
// What still holds it back (PERF.md, §6): a partial round's S-box is one
// chain of three Montgomery products on one thread, and 56 of the 64 rounds
// are partial; the s32 read-back goes through shared memory four times a
// round.
//
// The tile's permutation (load, rounds, store) lives in poseidon_bn254_a.cuh,
// shared with FRI's chain kernel (fri_merkle.cu); this file keeps the
// single-permutation kernel and its C entry.
//
// ptxas -v (sm_90a, nvcc 12.9, printed by chip_smoke.py on the H100): 118
// registers (116 before the permutation moved into the header), no spill
// stores or loads, 1 barrier; 55,296 bytes of dynamic shared memory a block
// (SMEM in the header).

#include <cuda_runtime.h>
#include <stdint.h>

#include "poseidon_bn254_a.cuh"

namespace {

using namespace pb_a;

__global__ void __launch_bounds__(TILE)
poseidon_bn254_kernel(const long long* __restrict__ in, long long* __restrict__ out,
                      const u32* __restrict__ c, const uint8_t* __restrict__ mats,
                      int n) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Tile tl = tile(smem);
  const long long first = (long long)blockIdx.x * TILE + (threadIdx.x >> 5) * 32;
  prefetch_first(tl, mats);
  Fe s[WIDTH];
  load_tile(s, tl, in, first, n);
  permute_tile(s, tl, c, mats, false);
  store_tile(s, tl, out, first, n);
}

bool smem_set[MAX_DEVICES] = {};

}  // namespace

extern "C" int p2t_poseidon_bn254_n_const() { return N_CONST; }

// in, out: (n, 4, 16) int64 Montgomery 16-bit limbs, contiguous and 16-byte
// aligned, on the device.  consts: N_CONST * 8 u32 words; mats: ROUNDS x
// 128 x 128 u8 round matrices (kernels/poseidon_bn254.round_matrices).
// Returns the first CUDA error, else 0.
extern "C" int p2t_poseidon_bn254_permute(const void* in, void* out, const void* consts,
                                          const void* mats, int n, void* stream) {
  const int err = allow_smem(poseidon_bn254_kernel, smem_set);
  if (err) return err;
  if (n > 0) {
    poseidon_bn254_kernel<<<(n + TILE - 1) / TILE, TILE, SMEM, (cudaStream_t)stream>>>(
        (const long long*)in, (long long*)out, (const u32*)consts,
        (const uint8_t*)mats, n);
  }
  return (int)cudaGetLastError();
}
