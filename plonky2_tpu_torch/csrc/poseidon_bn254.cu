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
// ptxas -v (sm_90a, nvcc 12.9, printed by chip_smoke.py on the H100): 116
// registers, no spill stores or loads, 1 barrier; 55,296 bytes of dynamic
// shared memory a block (SMEM below).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_mont.cuh"

namespace {

constexpr int WIDTH = 4;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 56;
constexpr int ROUNDS = 2 * HALF_FULL + PARTIAL;  // one matrix each

// Offsets (in field elements) into the constant buffer, in the order the
// wrapper (kernels/poseidon_bn254.const_elements) lays them out.  Kernel A
// reads the round constants; the linear layers come from the matrices.
constexpr int OFF_ARK0 = 0;                              // [4]
constexpr int OFF_ARK_FIRST = OFF_ARK0 + WIDTH;          // [4][4]
constexpr int OFF_ARK_SECOND = OFF_ARK_FIRST + 16;       // [4][4]
constexpr int OFF_M = OFF_ARK_SECOND + 16;               // [4 j][4 i]
constexpr int OFF_P = OFF_M + 16;                        // [4 j][4 i]
constexpr int OFF_PART_C = OFF_P + 16;                   // [56]
constexpr int OFF_S_ROW = OFF_PART_C + PARTIAL;          // [56][4]
constexpr int OFF_S_COL = OFF_S_ROW + PARTIAL * 4;       // [56][3]
constexpr int N_CONST = OFF_S_COL + PARTIAL * 3;

constexpr int ROW = WIDTH * 32;        // 128 bytes: a lane's state
constexpr int STRIDE = ROW + 16;       // padded row, bytes
constexpr int STRIDE_W = STRIDE / 4;   // padded row, 32-bit words
constexpr int MAT = ROW * ROW;         // a round matrix, bytes
constexpr int WARPS = 2;
constexpr int TILE = 32 * WARPS;       // lanes (and threads) a block
constexpr int LIMBS = WIDTH * 16;      // a lane's 16-bit limbs

// Shared memory, bytes: two matrix buffers, the A tile, the warps' s32
// read-back tiles (32 rows of 32 columns each, padded like A).
constexpr int SM_B = 0;
constexpr int SM_A = SM_B + 2 * ROW * STRIDE;
constexpr int SM_C = SM_A + TILE * STRIDE;
constexpr int SMEM = SM_C + WARPS * 32 * STRIDE;
constexpr int MAX_DEVICES = 64;  // devices whose shared-memory limit is kept

__device__ __forceinline__ u32 smem_addr(const void* p) {
  return (u32)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void prefetch_matrix(uint8_t* dst,
                                                const uint8_t* __restrict__ mats,
                                                int r) {
  const uint8_t* src = mats + (size_t)r * MAT;
  for (int q = threadIdx.x; q < ROW * ROW / 16; q += TILE) {
    const int row = q >> 3, chunk = (q & 7) * 16;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(smem_addr(dst + row * STRIDE + chunk)),
                    "l"(src + row * ROW + chunk) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(u32 (&r)[4], const uint8_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// d += a b on one 16 x 8 tile, K = 32 bytes.
__device__ __forceinline__ void mma_u8(int (&d)[4], const u32 (&a)[4], u32 b0,
                                       u32 b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ Fe load_const(const u32* __restrict__ c, int idx) {
  const uint4* p = reinterpret_cast<const uint4*>(c + idx * NW);
  const uint4 lo = __ldg(p), hi = __ldg(p + 1);
  return Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

// x^5 + ark for x < 2p: below 3p < 2^256, which is all the byte rows need.
__device__ __forceinline__ Fe exp5_ark(const Fe& x, const Fe& ark) {
  u32 t[ACC];
  mont<true>(t, x, x);
  const Fe x2 = low(t);
  mont<true>(t, x2, x2);
  const Fe x4 = low(t);
  mont<true>(t, x4, x);  // below 2p
  add_fold(t, ark);
  return low(t);
}

__device__ __forceinline__ void store_row(uint8_t* row, const Fe (&s)[WIDTH]) {
  uint4* p = reinterpret_cast<uint4*>(row);
#pragma unroll
  for (int e = 0; e < WIDTH; ++e) {
    p[2 * e] = make_uint4(s[e].w[0], s[e].w[1], s[e].w[2], s[e].w[3]);
    p[2 * e + 1] = make_uint4(s[e].w[4], s[e].w[5], s[e].w[6], s[e].w[7]);
  }
}

// Output element i of the round's linear layer for this thread's lane: the
// warp's 32 A rows times the 32 matrix columns of element i on the tensor
// cores, the s32 columns handed to their lane through the warp's C tile,
// then recombined, reduced and made canonical.
__device__ __forceinline__ Fe linear_out(const uint8_t* a_rows, const uint8_t* bt,
                                         int* c_tile, int i, bool partial) {
  const int lane = threadIdx.x & 31;
  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0;

  // ldmatrix: thread l addresses row (l & 7) of 8 x 16-byte matrix l >> 3.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int kk = 0; kk < WIDTH; ++kk) {
    // K step kk reads input element kk; a partial round's out_i (i > 0)
    // reads only s_0 and s_i.
    if (partial && i != 0 && kk != 0 && kk != i) continue;
    u32 a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(a[mt], a_rows + (mt * 16 + a_row) * STRIDE + kk * 32 + a_col);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      u32 b[4];  // b0, b1 of n tile 2 np, then of n tile 2 np + 1
      ldmatrix_x4(b, bt + (i * 32 + np * 16 + b_row) * STRIDE + kk * 32 + b_col);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_u8(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_u8(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }

  // Fragment (row g, columns 2t, 2t+1) and (row g + 8, the same columns).
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      int* p = c_tile + (mt * 16 + g) * STRIDE_W + nt * 8 + t2;
      *reinterpret_cast<int2*>(p) = make_int2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<int2*>(p + 8 * STRIDE_W) =
          make_int2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncwarp();
  int4 col[NW];  // col[w] = byte columns 4w .. 4w + 3 of this lane
  const int4* mine = reinterpret_cast<const int4*>(c_tile + lane * STRIDE_W);
#pragma unroll
  for (int w = 0; w < NW; ++w) col[w] = mine[w];
  __syncwarp();

  // sum_m col[m] 2^(8m) into 32-bit words: below 2^269, so t[8] < 2^13.
  u32 t[ACC];
  u64 c = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    c += (u64)(u32)col[w].x + ((u64)(u32)col[w].y << 8) +
         ((u64)(u32)col[w].z << 16) + ((u64)(u32)col[w].w << 24);
    t[w] = (u32)c;
    c >>= 32;
  }
  t[NW] = (u32)c;
  t[NW + 1] = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) reduce_step<true>(t);  // below p + 2^13
  return cond_sub(t, fe_p());
}

__global__ void __launch_bounds__(TILE)
poseidon_bn254_kernel(const long long* __restrict__ in, long long* __restrict__ out,
                      const u32* __restrict__ c, const uint8_t* __restrict__ mats,
                      int n) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* a_rows = smem + SM_A + warp * 32 * STRIDE;  // this warp's lanes
  int* c_tile = reinterpret_cast<int*>(smem + SM_C + warp * 32 * STRIDE);
  const long long first = (long long)blockIdx.x * TILE + warp * 32;

  prefetch_matrix(smem + SM_B, mats, 0);

  // The warp's 32 lanes, coalesced: two 16-bit limbs a 32-bit word, lane l's
  // words into A row l; lanes past n read as 0 and are never stored.
  const longlong2* src = reinterpret_cast<const longlong2*>(in + first * LIMBS);
#pragma unroll 4
  for (int l = 0; l < 32; ++l) {
    u32 word = 0;
    if (first + l < n) {
      const longlong2 v = src[l * 32 + lane];
      word = (u32)v.x | ((u32)v.y << 16);
    }
    reinterpret_cast<u32*>(a_rows + l * STRIDE)[lane] = word;
  }
  __syncwarp();
  Fe s[WIDTH];
  {
    u32 ark0_t[ACC];
    const uint4* mine = reinterpret_cast<const uint4*>(a_rows + lane * STRIDE);
#pragma unroll
    for (int e = 0; e < WIDTH; ++e) {
      const uint4 lo = mine[2 * e], hi = mine[2 * e + 1];
      zero(ark0_t);
      add_fold(ark0_t, Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}});
      add_fold(ark0_t, load_const(c, OFF_ARK0 + e));
      s[e] = low(ark0_t);  // canonical + ark < 2p
    }
  }

#pragma unroll 1
  for (int r = 0; r < ROUNDS; ++r) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // matrix r is in; the other buffer is free
    if (r + 1 < ROUNDS) prefetch_matrix(smem + SM_B + ((r + 1) & 1) * ROW * STRIDE,
                                        mats, r + 1);
    const bool partial = r >= HALF_FULL && r < HALF_FULL + PARTIAL;
    if (partial) {
      s[0] = exp5_ark(s[0], load_const(c, OFF_PART_C + r - HALF_FULL));
    } else {
      const int off = r < HALF_FULL ? OFF_ARK_FIRST + r * WIDTH
                                    : OFF_ARK_SECOND + (r - HALF_FULL - PARTIAL) * WIDTH;
#pragma unroll
      for (int e = 0; e < WIDTH; ++e) s[e] = exp5_ark(s[e], load_const(c, off + e));
    }
    store_row(a_rows + lane * STRIDE, s);
    __syncwarp();
    const uint8_t* bt = smem + SM_B + (r & 1) * ROW * STRIDE;
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = linear_out(a_rows, bt, c_tile, i, partial);
  }

  // The warp's 32 lanes out through the A rows, coalesced.
  __syncwarp();
  store_row(a_rows + lane * STRIDE, s);
  __syncwarp();
  longlong2* dst = reinterpret_cast<longlong2*>(out + first * LIMBS);
#pragma unroll 4
  for (int l = 0; l < 32; ++l) {
    if (first + l < n) {
      const u32 word = reinterpret_cast<const u32*>(a_rows + l * STRIDE)[lane];
      dst[l * 32 + lane] = make_longlong2(word & 0xFFFFu, word >> 16);
    }
  }
}

}  // namespace

extern "C" int p2t_poseidon_bn254_n_const() { return N_CONST; }

// in, out: (n, 4, 16) int64 Montgomery 16-bit limbs, contiguous and 16-byte
// aligned, on the device.  consts: N_CONST * 8 u32 words; mats: ROUNDS x
// 128 x 128 u8 round matrices (kernels/poseidon_bn254.round_matrices).
// Returns the first CUDA error, else 0.
extern "C" int p2t_poseidon_bn254_permute(const void* in, void* out, const void* consts,
                                          const void* mats, int n, void* stream) {
  // The shared-memory limit is set once per device (setting it twice is
  // harmless, so a race between threads costs nothing).
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || !smem_set[dev]) {
    err = cudaFuncSetAttribute(poseidon_bn254_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) smem_set[dev] = true;
  }
  if (n > 0) {
    poseidon_bn254_kernel<<<(n + TILE - 1) / TILE, TILE, SMEM, (cudaStream_t)stream>>>(
        (const long long*)in, (long long*)out, (const u32*)consts,
        (const uint8_t*)mats, n);
  }
  return (int)cudaGetLastError();
}
