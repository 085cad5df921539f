// FRI's Poseidon-BN254 hash chains for Hopper (sm_90a): every leaf sponge and
// Merkle climb of a verification in one launch, under either permutation
// form (kernel A's, poseidon_bn254_a.cuh; the CIOS form's,
// poseidon_bn254_cios.cuh).
//
// Replaces the two lax.scan loops of plonky2_tpu/fri/verify.py around the
// Pallas permutation (plonky2_tpu/kernels/poseidon_bn254_mxu.py:253, or
// poseidon_bn254_pallas.py:263 under PLONKY2_TPU_PB_IMPL=cios):
// _hash_leaves_scan (:101, HashNoPad over a leaf's absorb blocks) and
// _merkle_chain (:68, the climb from a leaf digest to a cap entry).
//
// A chain is one (proof, query round, kind): a kind is an initial oracle's
// tree or a reduction step's tree (fri/merkle.merkle_plan).  It starts from
// a zero state (or, for a HashOrNoop oracle of no absorb step, from its
// packed leaf as the digest), absorbs its steps (slot 0 kept, the masked
// slots 1..3 replaced by the leaf's block), then climbs depth levels (the
// sibling ordered by bit offset + level of the query index, permute
// [0, 0, left, right]), and writes element 0 of its state, the root, once.
// Every chain depends only on the proof's data, so they all run side by
// side; a chain's state stays on chip from its first absorb to its root.
//
// What bounds it on the H100: the permutations' 32-bit integer
// multiply-adds (90,496 a permutation in kernel A's form, 157,056 in the
// CIOS form); a step batch of 256 is 43,008 chains and 709,632
// permutations, 3.84 ms at the IMAD rate in kernel A's form.  A chain is a
// sequence of dependent permutations (28 on step), and a permutation is a
// long chain of dependent instructions: in kernel A's lane form a lone
// block takes about 0.37 ms a permutation, and 8 warps an SM about 0.55
// (PERF.md §6).  So the launch is the longest chains' time at the
// load their SMs carry, or the card's throughput, whichever is longer.  The
// design:
// - slot types (kernels/fri_merkle.launch_geometry): a type is an ordered
//   list of kinds, run back to back by each of its lane slots (the state
//   starting over, from zeros or a HashOrNoop leaf, after each root); the
//   launch names the threads that serve a lane.  Blocks run the types in
//   descriptor order, longest first, and a block holds one type, so its
//   threads run the same permutations and change chain at the same step; a
//   ragged tail's idle lanes run on a zero state and store nothing, and no
//   thread returns early.  The host packs kinds into one type (fri/merkle
//   .slot_plan) where that was measured faster: the CIOS lane form while it
//   gives every SM at most one block (PERF.md §6);
// - kernel A's form: the block's warps share one ring of STAGES round
//   matrices in shared memory.  Thread 0 fills a stage with one bulk copy
//   (cp.async.bulk, the TMA engine) of the round's 16 KB matrix, AHEAD
//   rounds before its use, onto the stage's full barrier (an mbarrier with
//   the copy's byte count); each warp waits on that barrier alone and, once
//   its last ldmatrix of the round is done, arrives on the stage's empty
//   barrier, which thread 0 waits on before it refills the stage.  No round
//   waits for the whole block (kernel A's single-permutation form runs
//   cp.async.wait_all and __syncthreads every round).  The matrices come
//   pre-swizzled from the wrapper (16-byte chunk c of row r at c ^ (r & 7),
//   kernels/fri_merkle.ring_matrices), so one contiguous copy lands ready
//   for conflict-free ldmatrix.  A warp's A rows (144 B each) double as its
//   C read-back tiles: the round's A fragments are held in registers before
//   the first C tile is written.  A lane runs on one thread (the lane form:
//   the four outputs' reductions side by side, for instruction-level
//   parallelism) or on two (the pair form: each thread holds two elements,
//   and the full rounds' S-boxes and the outputs' reductions split two and
//   two, so a lone block's permutation takes about 0.25 ms, but a lane
//   issues more instructions, the partial rounds' S-box on both threads):
//   the host takes the pair form while the card has room (latency sets the
//   time) and the lane form above (throughput does);
// - the CIOS form: a thread a chain (its four elements in registers), or a
//   group of 4 threads a chain while the card has room (as the CIOS
//   kernel); a chain's state is converted to the 29-bit domain once on
//   entry, each absorbed block and sibling as it is loaded, and the root
//   once on exit; between permutations the state stays below 1.08p, inside
//   the bounds the CIOS kernel's header proves for its input (below 32p);
// - the chains' descriptors go by value (__grid_constant__ Chains) and every
//   operand is read where it lies through its strides: the leaf blocks, the
//   siblings and the query index's two 32-bit words of any view, so no
//   gather or copy runs before the launch, nothing needs a reset between
//   launches (no atomic work queue), and the launch can be captured in a
//   CUDA graph.
//
// Registers, spills and resident blocks an SM: chip_smoke.py prints them
// (ptxas -v and the runtime's occupancy); times in PERF.md §6.
//
// A lane whose proof was quarantined may hold any limbs: the kernels read
// only inside the operands' shapes (the wrapper checks them) and never
// branch on the data, so such a lane computes a wrong root in its own lane
// and nothing else.

#include <cuda_runtime.h>
#include <stdint.h>

#include "poseidon_bn254_a.cuh"
#include "poseidon_bn254_cios.cuh"

namespace {

constexpr int MAX_KINDS = 8;
constexpr int MASK_WORDS = 2;                 // a kind's slot-mask words
constexpr int MAX_STEPS = 64 * MASK_WORDS / 3;  // 3 bits a step: 42
constexpr int INDEX_BITS = 64;                // the query index's two words
constexpr int MAX_THREADS = 256;              // a block's threads

// The host descriptor's words (kernels/fri_merkle.descriptor): the head,
// each kind's, then each slot type's.
constexpr int HEAD = 13;        // kinds, B, Q, n_out, (lo, hi): ptr, b, q
                                // stride, threads a block, threads a lane,
                                // slot types
constexpr int KIND_WORDS = 15;  // leaf ptr, b, q, step, slot strides; sibling
                                // ptr, b, q, level strides; steps, depth,
                                // offset, out, mask[2]
// A slot type's words: its kinds' count, then the kinds.

// One chain kind over the (B, Q) lanes.
struct Kind {
  const long long* leaf;   // (B, Q, steps, 3, 16) blocks; limbs contiguous
  const long long* sib;    // (B, Q, depth, 16) siblings; limbs contiguous
  long long leaf_stride[4];  // b, q, step, slot
  long long sib_stride[3];   // b, q, level
  unsigned long long mask[MASK_WORDS];  // bit 3 t + k: step t absorbs slot k
  int steps;   // absorb steps; 0: the digest is block 0's slot 0 (HashOrNoop)
  int depth;   // Merkle levels
  int offset;  // the query-index bit of level 0
  int out;     // the root's column in out
};

// A slot type: its lanes run chains of kinds kind[0..n) back to back.
struct Slot {
  int n;
  int kind[MAX_KINDS];
  int length;       // permutations, the kinds' summed
  int first_block;  // the type's first block: types run in descriptor order
};

struct Chains {
  long long lanes;  // B Q lanes; lane c is (c / Q, c % Q)
  int q, kinds, n_out, threads, types;
  int tpl;        // threads a lane
  int per_block;  // lanes a block: threads / tpl
  const long long* idx[2];     // the query index's lo, hi words, (B, Q)
  long long idx_stride[2][2];  // b, q
  Kind kind[MAX_KINDS];
  Slot slot[MAX_KINDS];
};

// The slot type of this block.
__device__ __forceinline__ const Slot& block_slot(const Chains& ch) {
  int k = 0;
#pragma unroll 1
  while (k + 1 < ch.types && (int)blockIdx.x >= ch.slot[k + 1].first_block) ++k;
  return ch.slot[k];
}

__device__ __forceinline__ const long long* block_at(const Kind& kd, long long b,
                                                     long long q, int t, int slot) {
  return kd.leaf + b * kd.leaf_stride[0] + q * kd.leaf_stride[1] +
         t * kd.leaf_stride[2] + slot * kd.leaf_stride[3];
}

__device__ __forceinline__ const long long* sibling_at(const Kind& kd, long long b,
                                                       long long q, int level) {
  return kd.sib + b * kd.sib_stride[0] + q * kd.sib_stride[1] +
         level * kd.sib_stride[2];
}

__device__ __forceinline__ bool absorbs(const Kind& kd, int t, int slot) {
  const int i = 3 * t + slot;
  return (kd.mask[i >> 6] >> (i & 63)) & 1;
}

// Bit `bit` of the query index of lane (b, q): its lo word holds bits 0..31.
__device__ __forceinline__ bool index_bit(const Chains& ch, long long b,
                                          long long q, int bit) {
  const int w = bit >> 5;
  const long long v = ch.idx[w][b * ch.idx_stride[w][0] + q * ch.idx_stride[w][1]];
  return (v >> (bit & 31)) & 1;
}

__device__ __forceinline__ long long* root_at(const Chains& ch, long long* out,
                                              long long b, long long q,
                                              const Kind& kd) {
  return out + ((b * ch.q + q) * ch.n_out + kd.out) * 16;
}

// This thread's lane slot: the lane (b, q), live while below B Q.
struct Lane {
  long long b, q;
  bool live;
};

__device__ __forceinline__ Lane lane_of(const Chains& ch, const Slot& sl) {
  const long long c = (long long)((int)blockIdx.x - sl.first_block) * ch.per_block +
                      threadIdx.x / ch.tpl;
  const bool live = c < ch.lanes;
  return Lane{live ? c / ch.q : 0, live ? c % ch.q : 0, live};
}

// ---- kernel A's form: the ring of round matrices ----------------------------

// A field element from 16 int64 limbs of 16 bits, as kernel A's words.
__device__ __forceinline__ Fe fe_at(const long long* src) {
  Fe x;
#pragma unroll
  for (int k = 0; k < NW; ++k) x.w[k] = (u32)src[2 * k] | ((u32)src[2 * k + 1] << 16);
  return x;
}

__device__ __forceinline__ Fe fe_zero() { return Fe{{0, 0, 0, 0, 0, 0, 0, 0}}; }

__device__ __forceinline__ void store_root(long long* dst, const Fe& x) {
  longlong2* d = reinterpret_cast<longlong2*>(dst);
#pragma unroll
  for (int k = 0; k < NW; ++k) d[k] = make_longlong2(x.w[k] & 0xFFFFu, x.w[k] >> 16);
}

namespace ring {

using pb_a::smem_addr;
using pb_a::STRIDE;
using pb_a::WIDTH;

constexpr int STAGES = 4;  // round matrices in the ring
constexpr int AHEAD = 2;   // rounds a stage is filled before its use
constexpr int MAT = pb_a::ROW * pb_a::ROW;  // a matrix, 16,384 bytes
constexpr int WARP_BYTES = 32 * STRIDE;  // a warp's A rows = its C tiles
constexpr int SM_ROWS = STAGES * MAT;

// Dynamic shared memory of a block of `warps` warps: the ring, the warps' A
// rows, then the full and the empty barriers (8 bytes each).
__host__ __device__ constexpr int smem_bytes(int warps) {
  return SM_ROWS + warps * WARP_BYTES + 2 * STAGES * 8;
}

__device__ __forceinline__ void bar_init(u32 bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count)
               : "memory");
}

// Until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(u32 bar, u32 parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void bar_arrive(u32 bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

struct Ring {
  uint8_t* stages;  // STAGES matrices
  u32 full, empty;  // the barriers' shared addresses, 8 bytes a stage
};

// Thread 0: the matrix of the block's round g in flight into its stage, once
// every warp has released the stage's last use (round g - STAGES).
__device__ __forceinline__ void fill(const Ring& rg, const uint8_t* __restrict__ mats,
                                     int g) {
  const int s = g % STAGES, use = g / STAGES;
  if (use > 0) bar_wait(rg.empty + 8 * s, (use - 1) & 1);
  const u32 bar = rg.full + 8 * s;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(MAT) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(rg.stages + s * MAT)),
         "l"(mats + (size_t)(g % pb_a::ROUNDS) * MAT), "r"(MAT), "r"(bar)
      : "memory");
}

// The top of the block's round g: thread 0 puts round g + AHEAD in flight,
// then every thread waits for round g's matrix; returns its stage.
__device__ __forceinline__ const uint8_t* enter(const Ring& rg,
                                                const uint8_t* __restrict__ mats,
                                                int g, int G) {
  if (threadIdx.x == 0 && g + AHEAD < G) fill(rg, mats, g + AHEAD);
  const int st = g % STAGES;
  bar_wait(rg.full + 8 * st, (g / STAGES) & 1);
  return rg.stages + st * MAT;
}

// The warp is done with round g's stage.
__device__ __forceinline__ void release(const Ring& rg, int g) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) bar_arrive(rg.empty + 8 * (g % STAGES));
}

// acc[mt] = the warp's 16 lanes of A fragments a[mt] times the 32 columns
// of output i of the round's matrix bt (swizzled rows of 128 bytes); a
// partial round's out_i (i > 0) reads only s_0 and s_i.
template <int MT>
__device__ __forceinline__ void mma_out(int (&acc)[MT][4][4], const u32 (&a)[MT][WIDTH][4],
                                        const uint8_t* bt, int i, bool partial) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0;
  // ldmatrix: thread l addresses row (l & 7) of 8 x 16-byte matrix l >> 3;
  // every row it names is l & 7 modulo 8, so its chunk sits at c ^ (l & 7).
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_half = (lane >> 3) & 1;
#pragma unroll
  for (int kk = 0; kk < WIDTH; ++kk) {
    if (partial && i != 0 && kk != 0 && kk != i) continue;
    const int chunk = (kk * 2 + b_half) ^ (lane & 7);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      u32 b[4];  // b0, b1 of n tile 2 np, then of n tile 2 np + 1
      pb_a::ldmatrix_x4(b, bt + (i * 32 + np * 16 + b_row) * pb_a::ROW + chunk * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pb_a::mma_u8(acc[mt][2 * np], a[mt][kk], b[0], b[1]);
        pb_a::mma_u8(acc[mt][2 * np + 1], a[mt][kk], b[2], b[3]);
      }
    }
  }
}

// The A fragments of 16 rows of 128 bytes at rows, every K step.
__device__ __forceinline__ void load_a16(u32 (&a)[WIDTH][4], const uint8_t* rows) {
  const int lane = threadIdx.x & 31;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
#pragma unroll
  for (int kk = 0; kk < WIDTH; ++kk)
    pb_a::ldmatrix_x4(a[kk], rows + a_row * STRIDE + kk * 32 + a_col);
}

// acc's fragments into the 16 C rows at row `first` of c_tile.
__device__ __forceinline__ void store_c(const int (&acc)[4][4], int* c_tile, int first) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    int* p = c_tile + (first + g) * pb_a::STRIDE_W + nt * 8 + t2;
    *reinterpret_cast<int2*>(p) = make_int2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<int2*>(p + 8 * pb_a::STRIDE_W) = make_int2(acc[nt][2], acc[nt][3]);
  }
}

// C row `row`'s s32 byte columns recombined into t: sum_m col[m] 2^(8m),
// below 2^269, so t[8] < 2^13.
__device__ __forceinline__ void recombine(const int* c_tile, int row, u32 (&t)[ACC]) {
  int4 col[NW];  // col[w] = byte columns 4w .. 4w + 3
  const int4* mine = reinterpret_cast<const int4*>(c_tile + row * pb_a::STRIDE_W);
#pragma unroll
  for (int w = 0; w < NW; ++w) col[w] = mine[w];
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
}

// t's Montgomery reduction, made canonical: below p + 2^13, then one
// subtraction of p.
__device__ __forceinline__ Fe canonical(u32 (&t)[ACC]) {
#pragma unroll
  for (int w = 0; w < NW; ++w) reduce_step<true>(t);
  return cond_sub(t, fe_p());
}

// x + ark, below 2p, for canonical x.
__device__ __forceinline__ Fe add_ark(const Fe& x, const Fe& ark) {
  u32 t[ACC];
  zero(t);
  add_fold(t, x);
  add_fold(t, ark);
  return low(t);
}

__device__ __forceinline__ bool partial_round(int r) {
  return r >= pb_a::HALF_FULL && r < pb_a::HALF_FULL + pb_a::PARTIAL;
}

// The constants' offset of full round r's ark.
__device__ __forceinline__ int full_ark(int r) {
  return r < pb_a::HALF_FULL
             ? pb_a::OFF_ARK_FIRST + r * WIDTH
             : pb_a::OFF_ARK_SECOND + (r - pb_a::HALF_FULL - pb_a::PARTIAL) * WIDTH;
}

// The lane form: the permutation of this thread's lane, s canonical in and
// out, the warp's 32 A rows at rows; g is the block's round counter, G its
// rounds in all.  The four outputs' reductions run side by side.
__device__ __forceinline__ void permute_lane(Fe (&s)[WIDTH], const Ring& rg, uint8_t* rows,
                                             const u32* __restrict__ c,
                                             const uint8_t* __restrict__ mats, int& g,
                                             int G) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < WIDTH; ++e)
    s[e] = add_ark(s[e], pb_a::load_const(c, pb_a::OFF_ARK0 + e));
#pragma unroll 1
  for (int r = 0; r < pb_a::ROUNDS; ++r, ++g) {
    const uint8_t* bt = enter(rg, mats, g, G);
    const bool partial = partial_round(r);
    if (partial) {
      s[0] = pb_a::exp5_ark(s[0], pb_a::load_const(c, pb_a::OFF_PART_C + r - pb_a::HALF_FULL));
    } else {
#pragma unroll
      for (int e = 0; e < WIDTH; ++e)
        s[e] = pb_a::exp5_ark(s[e], pb_a::load_const(c, full_ark(r) + e));
    }
    pb_a::store_row(rows + lane * STRIDE, s);
    __syncwarp();
    u32 a[2][WIDTH][4];  // rows 0..15, then 16..31
    load_a16(a[0], rows);
    load_a16(a[1], rows + 16 * STRIDE);
    __syncwarp();  // every lane's fragments are in before the C tile lands
    int* c_tile = reinterpret_cast<int*>(rows);
    u32 t[WIDTH][ACC];
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
      int acc[2][4][4];
      mma_out<2>(acc, a, bt, i, partial);
      if (i == WIDTH - 1) release(rg, g);  // the last read of the stage
      store_c(acc[0], c_tile, 0);
      store_c(acc[1], c_tile, 16);
      __syncwarp();
      recombine(c_tile, lane, t[i]);
      __syncwarp();
    }
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = canonical(t[i]);
  }
}

// Element 0 of this thread's lane (its h = 0 thread's e[0]) on both threads
// of the pair form.
__device__ __forceinline__ Fe pair_s0(const Fe& e0) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k)
    r.w[k] = __shfl_sync(0xffffffffu, e0.w[k], (threadIdx.x & 31) & ~1);
  return r;
}

// The pair form: a warp holds 16 lanes, thread t serving lane t >> 1 and
// holding its elements 2 h and 2 h + 1 (h = t & 1) as e.  The full rounds'
// four S-boxes and the four outputs' reductions split two and two; the
// partial rounds' S-box runs on both threads of the lane (one chain, which
// the warp issues once for its 32 threads).  The warp's 16 A rows double as
// its C tiles of two outputs (2 x 16 rows), read back in two passes:
// outputs (0, 2), then (1, 3), thread h taking output 2 h + pass.
__device__ __forceinline__ void permute_pair(Fe (&e)[2], const Ring& rg, uint8_t* rows,
                                             const u32* __restrict__ c,
                                             const uint8_t* __restrict__ mats, int& g,
                                             int G) {
  const int lane = threadIdx.x & 31, h = lane & 1, l = lane >> 1;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    e[j] = add_ark(e[j], pb_a::load_const(c, pb_a::OFF_ARK0 + 2 * h + j));
#pragma unroll 1
  for (int r = 0; r < pb_a::ROUNDS; ++r, ++g) {
    const uint8_t* bt = enter(rg, mats, g, G);
    const bool partial = partial_round(r);
    if (partial) {
      const Fe y = pb_a::exp5_ark(
          pair_s0(e[0]), pb_a::load_const(c, pb_a::OFF_PART_C + r - pb_a::HALF_FULL));
      if (h == 0) e[0] = y;
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        e[j] = pb_a::exp5_ark(e[j], pb_a::load_const(c, full_ark(r) + 2 * h + j));
    }
    uint4* mine = reinterpret_cast<uint4*>(rows + l * STRIDE + h * 64);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mine[2 * j] = make_uint4(e[j].w[0], e[j].w[1], e[j].w[2], e[j].w[3]);
      mine[2 * j + 1] = make_uint4(e[j].w[4], e[j].w[5], e[j].w[6], e[j].w[7]);
    }
    __syncwarp();
    u32 a[1][WIDTH][4];
    load_a16(a[0], rows);
    __syncwarp();  // every lane's fragments are in before the C tiles land
    int* c_tile = reinterpret_cast<int*>(rows);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int acc0[1][4][4], acc1[1][4][4];
      mma_out<1>(acc0, a, bt, j, partial);
      mma_out<1>(acc1, a, bt, j + 2, partial);
      if (j == 1) release(rg, g);  // the last read of the stage
      store_c(acc0[0], c_tile, 0);
      store_c(acc1[0], c_tile, 16);
      __syncwarp();
      u32 t[ACC];
      recombine(c_tile, h * 16 + l, t);  // output 2 h + j
      e[j] = canonical(t);
      __syncwarp();
    }
  }
}

}  // namespace ring

// The lane form's chains of this block's slot type.
__device__ __forceinline__ void chains_lane(const Chains& ch, const Slot& sl,
                                            const ring::Ring& rg, uint8_t* rows,
                                            const u32* __restrict__ c,
                                            const uint8_t* __restrict__ mats, int G,
                                            long long* __restrict__ out) {
  const Lane ln = lane_of(ch, sl);
  int g = 0;
#pragma unroll 1
  for (int j = 0; j < sl.n; ++j) {
    const Kind& kd = ch.kind[sl.kind[j]];
    Fe s[pb_a::WIDTH];
#pragma unroll
    for (int e = 0; e < pb_a::WIDTH; ++e) s[e] = fe_zero();
    if (kd.steps == 0 && ln.live) s[0] = fe_at(block_at(kd, ln.b, ln.q, 0, 0));
    const int length = kd.steps + kd.depth;
#pragma unroll 1
    for (int t = 0; t < length; ++t) {
      if (t < kd.steps) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
          if (absorbs(kd, t, k))
            s[k + 1] = ln.live ? fe_at(block_at(kd, ln.b, ln.q, t, k)) : fe_zero();
      } else {
        const int level = t - kd.steps;
        const Fe sib = ln.live ? fe_at(sibling_at(kd, ln.b, ln.q, level)) : fe_zero();
        const bool right = ln.live && index_bit(ch, ln.b, ln.q, kd.offset + level);
        const Fe cur = s[0];
        s[0] = s[1] = fe_zero();
        s[2] = right ? sib : cur;
        s[3] = right ? cur : sib;
      }
      ring::permute_lane(s, rg, rows, c, mats, g, G);
    }
    if (ln.live) store_root(root_at(ch, out, ln.b, ln.q, kd), s[0]);
  }
}

// The pair form's chains of this block's slot type.
__device__ __forceinline__ void chains_pair(const Chains& ch, const Slot& sl,
                                            const ring::Ring& rg, uint8_t* rows,
                                            const u32* __restrict__ c,
                                            const uint8_t* __restrict__ mats, int G,
                                            long long* __restrict__ out) {
  const Lane ln = lane_of(ch, sl);
  const int h = threadIdx.x & 1;
  int g = 0;
#pragma unroll 1
  for (int j = 0; j < sl.n; ++j) {
    const Kind& kd = ch.kind[sl.kind[j]];
    Fe e[2] = {fe_zero(), fe_zero()};
    if (kd.steps == 0 && ln.live && h == 0) e[0] = fe_at(block_at(kd, ln.b, ln.q, 0, 0));
    const int length = kd.steps + kd.depth;
#pragma unroll 1
    for (int t = 0; t < length; ++t) {
      if (t < kd.steps) {
        // element 2 h + i takes block slot 2 h + i - 1
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int k = 2 * h + i - 1;
          if (k >= 0 && absorbs(kd, t, k))
            e[i] = ln.live ? fe_at(block_at(kd, ln.b, ln.q, t, k)) : fe_zero();
        }
      } else {
        // every thread of the warp takes part in the shuffle
        const int level = t - kd.steps;
        const Fe cur = ring::pair_s0(e[0]);
        Fe sib = fe_zero();
        bool right = false;
        if (h == 1 && ln.live) {
          sib = fe_at(sibling_at(kd, ln.b, ln.q, level));
          right = index_bit(ch, ln.b, ln.q, kd.offset + level);
        }
        // [0, 0, left, right]: thread 1 holds elements 2 and 3
        e[0] = h == 0 ? fe_zero() : (right ? sib : cur);
        e[1] = h == 0 ? fe_zero() : (right ? cur : sib);
      }
      ring::permute_pair(e, rg, rows, c, mats, g, G);
    }
    if (ln.live && h == 0) store_root(root_at(ch, out, ln.b, ln.q, kd), e[0]);
  }
}

// PAIR: two threads a lane; else one.
template <bool PAIR>
__global__ void __launch_bounds__(MAX_THREADS, 1)
merkle_chains_a_kernel(const __grid_constant__ Chains ch, long long* __restrict__ out,
                       const u32* __restrict__ c, const uint8_t* __restrict__ mats) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int warps = blockDim.x >> 5;
  uint8_t* bars = smem + ring::SM_ROWS + warps * ring::WARP_BYTES;
  const ring::Ring rg{smem, ring::smem_addr(bars),
                      ring::smem_addr(bars + 8 * ring::STAGES)};
  uint8_t* rows = smem + ring::SM_ROWS + (threadIdx.x >> 5) * ring::WARP_BYTES;
  const Slot& sl = block_slot(ch);
  const int G = pb_a::ROUNDS * sl.length;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ring::STAGES; ++s) {
      ring::bar_init(rg.full + 8 * s, 1);
      ring::bar_init(rg.empty + 8 * s, warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int g = 0; g < ring::AHEAD && g < G; ++g) ring::fill(rg, mats, g);

  if (PAIR)
    chains_pair(ch, sl, rg, rows, c, mats, G, out);
  else
    chains_lane(ch, sl, rg, rows, c, mats, G, out);
}

// ---- the CIOS form ----------------------------------------------------------

// GROUP: a group of G threads a chain (thread e holds element e); else a
// thread a chain.  (pb_cios's names are qualified: bn254_mont.cuh's share
// some of them.)
namespace pc = pb_cios;

template <bool GROUP>
__global__ void __launch_bounds__(GROUP ? pc::THREADS : MAX_THREADS, 1)
merkle_chains_cios_kernel(const __grid_constant__ Chains ch, long long* __restrict__ out,
                          const uint32_t* __restrict__ consts) {
  __shared__ __align__(16) uint32_t kC[pc::N_CONST * pc::NL];
  pc::load_consts(kC, consts);
  const Slot& sl = block_slot(ch);
  const Lane ln = lane_of(ch, sl);

  if (GROUP) {
    const int e = threadIdx.x % pc::G;
#pragma unroll 1
    for (int j = 0; j < sl.n; ++j) {
      const Kind& kd = ch.kind[sl.kind[j]];
      const int length = kd.steps + kd.depth;
      pc::Fl s = pc::fl_zero();
      if (kd.steps == 0 && ln.live && e == 0)
        s = pc::to_domain(block_at(kd, ln.b, ln.q, 0, 0));
#pragma unroll 1
      for (int t = 0; t < length; ++t) {
        if (t < kd.steps) {
          if (e > 0 && absorbs(kd, t, e - 1))
            s = ln.live ? pc::to_domain(block_at(kd, ln.b, ln.q, t, e - 1)) : pc::fl_zero();
        } else {
          // every thread of the warp takes part in the shuffle
          const int level = t - kd.steps;
          const pc::Fl cur = pc::shfl(s, 0);
          pc::Fl sib = pc::fl_zero();
          bool right = false;
          if (e >= 2 && ln.live) {
            sib = pc::to_domain(sibling_at(kd, ln.b, ln.q, level));
            right = index_bit(ch, ln.b, ln.q, kd.offset + level);
          }
          // [0, 0, left, right]: thread 2 takes left, thread 3 right
          s = e < 2 ? pc::fl_zero() : ((e == 2) == right ? sib : cur);
        }
        s = pc::permute_group(s, kC, e);
      }
      if (ln.live && e == 0) pc::store_element(root_at(ch, out, ln.b, ln.q, kd), s);
    }
  } else {
#pragma unroll 1
    for (int j = 0; j < sl.n; ++j) {
      const Kind& kd = ch.kind[sl.kind[j]];
      const int length = kd.steps + kd.depth;
      pc::Fl s[pc::WIDTH];
#pragma unroll
      for (int e = 0; e < pc::WIDTH; ++e) s[e] = pc::fl_zero();
      if (kd.steps == 0 && ln.live) s[0] = pc::to_domain(block_at(kd, ln.b, ln.q, 0, 0));
#pragma unroll 1
      for (int t = 0; t < length; ++t) {
        if (t < kd.steps) {
#pragma unroll
          for (int k = 0; k < 3; ++k)
            if (absorbs(kd, t, k))
              s[k + 1] = ln.live ? pc::to_domain(block_at(kd, ln.b, ln.q, t, k))
                                 : pc::fl_zero();
        } else {
          const int level = t - kd.steps;
          const pc::Fl sib =
              ln.live ? pc::to_domain(sibling_at(kd, ln.b, ln.q, level)) : pc::fl_zero();
          const bool right = ln.live && index_bit(ch, ln.b, ln.q, kd.offset + level);
          const pc::Fl cur = s[0];
          s[0] = s[1] = pc::fl_zero();
          s[2] = right ? sib : cur;
          s[3] = right ? cur : sib;
        }
        pc::permute_lane(s, kC);
      }
      if (ln.live) pc::store_element(root_at(ch, out, ln.b, ln.q, kd), s[0]);
    }
  }
}

// The descriptor's words into ch; returns the grid's blocks, or -1 on a
// malformed descriptor.
long long parse(const long long* d, Chains& ch) {
  const long long kinds = d[0], B = d[1], Q = d[2], n_out = d[3];
  const long long threads = d[10], tpl = d[11], types = d[12];
  if (kinds < 1 || kinds > MAX_KINDS || B < 0 || Q < 1 || Q > (1 << 30) ||
      n_out < kinds || n_out > MAX_KINDS || threads < 32 || threads % 32 ||
      threads > MAX_THREADS || tpl < 1 || threads % tpl || types < 1 ||
      types > MAX_KINDS)
    return -1;
  ch.lanes = B * Q;
  ch.q = (int)Q;
  ch.kinds = (int)kinds;
  ch.n_out = (int)n_out;
  ch.threads = (int)threads;
  ch.tpl = (int)tpl;
  ch.per_block = (int)(threads / tpl);
  ch.types = (int)types;
  for (int w = 0; w < 2; ++w) {
    ch.idx[w] = (const long long*)d[4 + 3 * w];
    ch.idx_stride[w][0] = d[5 + 3 * w];
    ch.idx_stride[w][1] = d[6 + 3 * w];
  }
  for (int k = 0; k < MAX_KINDS; ++k) {
    Kind& kd = ch.kind[k];
    if (k >= kinds) {
      kd = Kind{};
      continue;
    }
    const long long* p = d + HEAD + KIND_WORDS * k;
    kd.leaf = (const long long*)p[0];
    for (int i = 0; i < 4; ++i) kd.leaf_stride[i] = p[1 + i];
    kd.sib = (const long long*)p[5];
    for (int i = 0; i < 3; ++i) kd.sib_stride[i] = p[6 + i];
    const long long steps = p[9], depth = p[10], offset = p[11], o = p[12];
    if (steps < 0 || steps > MAX_STEPS || depth < 0 || offset < 0 ||
        offset + depth > INDEX_BITS || o < 0 || o >= n_out)
      return -1;
    kd.steps = (int)steps;
    kd.depth = (int)depth;
    kd.offset = (int)offset;
    kd.out = (int)o;
    for (int i = 0; i < MASK_WORDS; ++i) kd.mask[i] = (unsigned long long)p[13 + i];
  }
  const long long* p = d + HEAD + KIND_WORDS * kinds;
  long long blocks = 0;
  for (int t = 0; t < MAX_KINDS; ++t) {
    Slot& sl = ch.slot[t];
    sl = Slot{};
    if (t >= types) continue;
    const long long n = *p++;
    if (n < 1 || n > kinds) return -1;
    sl.n = (int)n;
    for (int j = 0; j < n; ++j) {
      const long long k = *p++;
      if (k < 0 || k >= kinds) return -1;
      sl.kind[j] = (int)k;
      sl.length += ch.kind[k].steps + ch.kind[k].depth;
    }
    sl.first_block = (int)blocks;
    blocks += (ch.lanes + ch.per_block - 1) / ch.per_block;
  }
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

bool smem_set[pb_a::MAX_DEVICES] = {};

// Kernel A's form's dynamic shared-memory limit, set once per device (setting
// it twice is harmless).
int allow_ring_smem() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= pb_a::MAX_DEVICES || !smem_set[dev]) {
    const int bytes = ring::smem_bytes(MAX_THREADS / 32);
    err = cudaFuncSetAttribute(merkle_chains_a_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(merkle_chains_a_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < pb_a::MAX_DEVICES) smem_set[dev] = true;
  }
  return 0;
}

// The kernel of p2t_merkle_chains_info's form number.
const void* form_kernel(int form) {
  switch (form) {
    case 0: return (const void*)merkle_chains_a_kernel<false>;
    case 1: return (const void*)merkle_chains_a_kernel<true>;
    case 2: return (const void*)merkle_chains_cios_kernel<true>;
    case 3: return (const void*)merkle_chains_cios_kernel<false>;
    default: return nullptr;
  }
}

}  // namespace

// desc: the host descriptor's words (HEAD, with threads a lane 1 for the
// lane form or 2 for the pair form; KIND_WORDS a kind in plan order; then
// each slot type's kinds' count and kinds); out: (B, Q, n_out, 16) int64,
// contiguous, on the device; consts, mats: kernel A's constant words and
// the ring's swizzled round matrices (kernels/fri_merkle._ring_tables).
// Returns the first CUDA error, else 0.
extern "C" int p2t_merkle_chains_a(const long long* desc, void* out,
                                   const void* consts, const void* mats,
                                   void* stream) {
  Chains ch;
  const long long blocks = parse(desc, ch);
  if (blocks < 0 || ch.tpl > 2) return (int)cudaErrorInvalidValue;
  const int err = allow_ring_smem();
  if (err) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int smem = ring::smem_bytes(ch.threads / 32);
  if (blocks > 0) {
    if (ch.tpl == 2)
      merkle_chains_a_kernel<true><<<(unsigned)blocks, ch.threads, smem, st>>>(
          ch, (long long*)out, (const u32*)consts, (const uint8_t*)mats);
    else
      merkle_chains_a_kernel<false><<<(unsigned)blocks, ch.threads, smem, st>>>(
          ch, (long long*)out, (const u32*)consts, (const uint8_t*)mats);
  }
  return (int)cudaGetLastError();
}

// As p2t_merkle_chains_a, with the CIOS kernel's constants
// (kernels/poseidon_bn254_cios._kernel_consts), 4 threads a lane (the
// group form) or 1 (the lane form).
extern "C" int p2t_merkle_chains_cios(const long long* desc, void* out,
                                      const void* consts, void* stream) {
  Chains ch;
  const long long blocks = parse(desc, ch);
  const bool group = ch.tpl == pb_cios::G;
  if (blocks < 0 || !(group || ch.tpl == 1)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (blocks > 0) {
    if (group)
      merkle_chains_cios_kernel<true><<<(unsigned)blocks, ch.threads, 0, st>>>(
          ch, (long long*)out, (const uint32_t*)consts);
    else
      merkle_chains_cios_kernel<false><<<(unsigned)blocks, ch.threads, 0, st>>>(
          ch, (long long*)out, (const uint32_t*)consts);
  }
  return (int)cudaGetLastError();
}

// What a launch of a form can count on, on the current device: info[0] the
// SMs, info[1] the blocks of `threads` threads an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, with kernel A's ring and
// rows for threads / 32 warps), info[2] registers a thread, info[3] local
// (spill) bytes a thread, info[4] the most threads a block.  form: 0
// kernel A's lane form, 1 its pair form, 2 the CIOS group form, 3 the CIOS
// lane form.
extern "C" int p2t_merkle_chains_info(int form, int threads, int* info) {
  const void* fn = form_kernel(form);
  if (!fn || threads < 32 || threads % 32 || threads > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&info[0], cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int smem = 0;
  if (form < 2) {
    const int err = allow_ring_smem();
    if (err) return err;
    smem = ring::smem_bytes(threads / 32);
  }
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, fn);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], fn, threads, smem);
  if (e != cudaSuccess) return (int)e;
  info[2] = fa.numRegs;
  info[3] = (int)fa.localSizeBytes;
  info[4] = fa.maxThreadsPerBlock;
  return 0;
}
