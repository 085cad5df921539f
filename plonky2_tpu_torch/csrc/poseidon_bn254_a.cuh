// Kernel A's permutation of one tile of 64 lanes, shared by the
// single-permutation kernel (poseidon_bn254.cu) and FRI's chain kernel
// (fri_merkle.cu, merkle_chains_a_kernel).  The design and its bounds are in
// poseidon_bn254.cu's header: the rounds' S-boxes on the CUDA cores
// (bn254_mont.cuh), each linear layer one byte-matrix product on the int8
// tensor cores (mma.sync), the 64 round matrices streamed by cp.async into
// two shared buffers, one __syncthreads a round.
//
// A block is one tile: TILE threads, one lane each, SMEM bytes of dynamic
// shared memory.  Every thread of the block must call permute_tile the same
// number of times (the rounds synchronise the block), so a lane without work
// permutes a zero state and stores nothing.
//
// The matrix stream runs across permutations: on entry to permute_tile,
// matrix 0 must be in flight into buffer 0 (prefetch_first), and with
// `next` the last round puts the next permutation's matrix 0 in flight
// there (round 63 reads buffer 1, so buffer 0 is free).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_mont.cuh"

namespace {
namespace pb_a {

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

// This thread's warp's A rows and C tile in the block's shared memory.
struct Tile {
  uint8_t* smem;
  uint8_t* a_rows;
  int* c_tile;
};

__device__ __forceinline__ Tile tile(uint8_t* smem) {
  const int warp = threadIdx.x >> 5;
  return Tile{smem, smem + SM_A + warp * 32 * STRIDE,
              reinterpret_cast<int*>(smem + SM_C + warp * 32 * STRIDE)};
}

// Matrix 0 in flight into buffer 0, before a block's first permute_tile.
__device__ __forceinline__ void prefetch_first(const Tile& tl,
                                               const uint8_t* __restrict__ mats) {
  prefetch_matrix(tl.smem + SM_B, mats, 0);
}

// The permutation of this thread's lane: s canonical in, canonical out.  With
// `next`, the next permutation's matrix 0 is in flight on return.
__device__ __forceinline__ void permute_tile(Fe (&s)[WIDTH], const Tile& tl,
                                             const u32* __restrict__ c,
                                             const uint8_t* __restrict__ mats,
                                             bool next) {
  const int lane = threadIdx.x & 31;
  {
    u32 ark0_t[ACC];
#pragma unroll
    for (int e = 0; e < WIDTH; ++e) {
      zero(ark0_t);
      add_fold(ark0_t, s[e]);
      add_fold(ark0_t, load_const(c, OFF_ARK0 + e));
      s[e] = low(ark0_t);  // canonical + ark < 2p
    }
  }

#pragma unroll 1
  for (int r = 0; r < ROUNDS; ++r) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // matrix r is in; the other buffer is free
    if (r + 1 < ROUNDS)
      prefetch_matrix(tl.smem + SM_B + ((r + 1) & 1) * ROW * STRIDE, mats, r + 1);
    else if (next)
      prefetch_first(tl, mats);
    const bool partial = r >= HALF_FULL && r < HALF_FULL + PARTIAL;
    if (partial) {
      s[0] = exp5_ark(s[0], load_const(c, OFF_PART_C + r - HALF_FULL));
    } else {
      const int off = r < HALF_FULL ? OFF_ARK_FIRST + r * WIDTH
                                    : OFF_ARK_SECOND + (r - HALF_FULL - PARTIAL) * WIDTH;
#pragma unroll
      for (int e = 0; e < WIDTH; ++e) s[e] = exp5_ark(s[e], load_const(c, off + e));
    }
    store_row(tl.a_rows + lane * STRIDE, s);
    __syncwarp();
    const uint8_t* bt = tl.smem + SM_B + (r & 1) * ROW * STRIDE;
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = linear_out(tl.a_rows, bt, tl.c_tile, i, partial);
  }
}

// The warp's 32 lanes from (n, 4, 16) int64 limbs, coalesced: two 16-bit
// limbs a 32-bit word, lane l's words into A row l; lanes past n read as 0.
// first: the warp's first lane.
__device__ __forceinline__ void load_tile(Fe (&s)[WIDTH], const Tile& tl,
                                          const long long* __restrict__ in,
                                          long long first, int n) {
  const int lane = threadIdx.x & 31;
  const longlong2* src = reinterpret_cast<const longlong2*>(in + first * LIMBS);
#pragma unroll 4
  for (int l = 0; l < 32; ++l) {
    u32 word = 0;
    if (first + l < n) {
      const longlong2 v = src[l * 32 + lane];
      word = (u32)v.x | ((u32)v.y << 16);
    }
    reinterpret_cast<u32*>(tl.a_rows + l * STRIDE)[lane] = word;
  }
  __syncwarp();
  const uint4* mine = reinterpret_cast<const uint4*>(tl.a_rows + lane * STRIDE);
#pragma unroll
  for (int e = 0; e < WIDTH; ++e) {
    const uint4 lo = mine[2 * e], hi = mine[2 * e + 1];
    s[e] = Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
  }
}

// The warp's 32 lanes out through the A rows, coalesced; lanes past n are
// not stored.
__device__ __forceinline__ void store_tile(const Fe (&s)[WIDTH], const Tile& tl,
                                           long long* __restrict__ out,
                                           long long first, int n) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  store_row(tl.a_rows + lane * STRIDE, s);
  __syncwarp();
  longlong2* dst = reinterpret_cast<longlong2*>(out + first * LIMBS);
#pragma unroll 4
  for (int l = 0; l < 32; ++l) {
    if (first + l < n) {
      const u32 word = reinterpret_cast<const u32*>(tl.a_rows + l * STRIDE)[lane];
      dst[l * 32 + lane] = make_longlong2(word & 0xFFFFu, word >> 16);
    }
  }
}

// Sets the kernel's dynamic shared-memory limit to SMEM once per device
// (setting it twice is harmless, so a race between threads costs nothing).
constexpr int MAX_DEVICES = 64;  // devices whose limit is kept

template <typename Kernel>
int allow_smem(Kernel kernel, bool (&set)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || !set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) set[dev] = true;
  }
  return 0;
}

}  // namespace pb_a
}  // namespace
