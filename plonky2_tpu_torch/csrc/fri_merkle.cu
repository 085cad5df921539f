// FRI's Poseidon-BN254 hash chains for Hopper (sm_90a): every leaf sponge and
// Merkle climb of a verification in one launch, under either permutation
// form (kernel A's, poseidon_bn254_a.cuh; the CIOS form's,
// poseidon_bn254_cios.cuh).
//
// Replaces the two lax.scan loops of plonky2_tpu/fri/verify.py around the
// Pallas permutation (plonky2_tpu/kernels/poseidon_bn254_mxu.py:253, or
// poseidon_bn254_pallas.py:263 under PLONKY2_TPU_PB_IMPL=cios):
// _hash_leaves_scan (:101, HashNoPad over a leaf's absorb blocks) and
// _merkle_chain (:68, the climb from a leaf digest to a cap entry), which
// the port ran as one launch of a whole permutation per absorb step and
// tree level (63 on a step batch), each with its plain ops between.
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
// multiply-adds, as for the single-permutation kernels (90,496 a
// permutation in kernel A's form, 157,056 in the CIOS form); a step batch
// of 256 is 43,008 chains and 709,632 permutations, 3.84 ms at the IMAD
// rate in kernel A's form.  The single-permutation launches were
// latency-bound: one launch's time hardly moved with its width (PERF.md,
// §6), and 63 of them ran one after another.  Here the longest chain, 28
// permutations, is the latency bound (28 x 0.009 ms), and the card holds
// every chain at once.  The design:
// - one chain kind a block, so every thread of a block runs the same number
//   of permutations (kernel A synchronises its block every round); a ragged
//   tail's idle lanes run on a zero state and store nothing, and no thread
//   returns early;
// - blocks run the longest chain kind first (the wrapper orders the kinds),
//   so the tail is short chains;
// - kernel A's form: a tile of 64 chains a block, as kernel A; the matrix
//   stream runs on across the chain's permutations.  The CIOS form: a group
//   of 4 threads a chain (32 chains a block) while one thread a chain would
//   give the card fewer than two warps an SM (below 8448 chains on the
//   H100), one thread a chain (128 a block) above, as the CIOS kernel picks;
//   a chain's state is converted to the 29-bit domain once on entry, each
//   absorbed block and sibling as it is loaded, and the root once on exit;
//   between permutations the state stays below 1.08p, inside the bounds the
//   CIOS kernel's header proves for its input (below 32p);
// - the chains' descriptors go by value (__grid_constant__ Chains) and every
//   operand is read where it lies through its strides: the leaf blocks, the
//   siblings and the query index's two 32-bit words of any view, so no
//   gather or copy runs before the launch, and the launch can be captured in
//   a CUDA graph.
//
// Measured (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W): at step B=256 17.5
// to 17.9 ms in kernel A's form and 13.4 to 13.7 in the CIOS form, against
// 32.2 and 21.6 for the 63 single-permutation launches; both launches are
// 1.27 waves (672 blocks of 64 chains, 4 resident an SM; 336 of 128, 2 an
// SM), and a chain's permutation runs at the single kernel's speed, so the
// longest chain's 28 permutations set the time.
//
// ptxas -v (sm_90a, nvcc 12.9): merkle_chains_a_kernel 104 registers, no
// spills; merkle_chains_cios_kernel<true> 80 registers, no spills;
// <false> 254 registers, a 32-byte stack frame, 8 bytes of spill stores
// and loads.
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

// The host descriptor's words (kernels/fri_merkle.descriptor): the head,
// then each kind's.
constexpr int HEAD = 10;        // kinds, B, Q, n_out, (lo, hi): ptr, b, q stride
constexpr int KIND_WORDS = 15;  // leaf ptr, b, q, step, slot strides; sibling
                                // ptr, b, q, level strides; steps, depth,
                                // offset, out, mask[2]

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
  int first_block;  // the kind's first block: kinds run in descriptor order
};

struct Chains {
  long long lanes;  // B Q chains a kind; chain c is lane (c / Q, c % Q)
  int q, kinds, n_out;
  const long long* idx[2];     // the query index's lo, hi words, (B, Q)
  long long idx_stride[2][2];  // b, q
  Kind kind[MAX_KINDS];
};

// The kind of this block.
__device__ __forceinline__ const Kind& block_kind(const Chains& ch) {
  int k = 0;
#pragma unroll 1
  while (k + 1 < ch.kinds && (int)blockIdx.x >= ch.kind[k + 1].first_block) ++k;
  return ch.kind[k];
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

// This thread's chain: the lane (b, q), live while below B Q.
struct Lane {
  long long b, q;
  bool live;
};

__device__ __forceinline__ Lane lane_of(const Chains& ch, const Kind& kd,
                                        int per_block, int slot) {
  const long long c = (long long)((int)blockIdx.x - kd.first_block) * per_block + slot;
  const bool live = c < ch.lanes;
  return Lane{live ? c / ch.q : 0, live ? c % ch.q : 0, live};
}

// ---- kernel A's form ------------------------------------------------------

// A field element from 16 int64 limbs of 16 bits, as kernel A's words.
__device__ __forceinline__ Fe fe_at(const long long* src) {
  Fe x;
#pragma unroll
  for (int k = 0; k < NW; ++k) x.w[k] = (u32)src[2 * k] | ((u32)src[2 * k + 1] << 16);
  return x;
}

__device__ __forceinline__ Fe fe_zero() { return Fe{{0, 0, 0, 0, 0, 0, 0, 0}}; }

__global__ void __launch_bounds__(pb_a::TILE)
merkle_chains_a_kernel(const __grid_constant__ Chains ch, long long* __restrict__ out,
                       const u32* __restrict__ c, const uint8_t* __restrict__ mats) {
  extern __shared__ __align__(16) uint8_t smem[];
  const pb_a::Tile tl = pb_a::tile(smem);
  const Kind& kd = block_kind(ch);
  const Lane ln = lane_of(ch, kd, pb_a::TILE, threadIdx.x);
  pb_a::prefetch_first(tl, mats);

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
    pb_a::permute_tile(s, tl, c, mats, t + 1 < length);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");  // a chain of no permutation

  if (ln.live) {
    longlong2* dst = reinterpret_cast<longlong2*>(root_at(ch, out, ln.b, ln.q, kd));
#pragma unroll
    for (int k = 0; k < NW; ++k)
      dst[k] = make_longlong2(s[0].w[k] & 0xFFFFu, s[0].w[k] >> 16);
  }
}

// ---- the CIOS form ----------------------------------------------------------

// GROUP: a group of G threads a chain (thread e holds element e), LANES
// chains a block; else a thread a chain, LANE_THREADS a block.  (pb_cios's
// names are qualified: bn254_mont.cuh's share some of them.)
namespace pc = pb_cios;

template <bool GROUP>
__global__ void __launch_bounds__(GROUP ? pc::THREADS : pc::LANE_THREADS)
merkle_chains_cios_kernel(const __grid_constant__ Chains ch, long long* __restrict__ out,
                          const uint32_t* __restrict__ consts) {
  __shared__ __align__(16) uint32_t kC[pc::N_CONST * pc::NL];
  pc::load_consts(kC, consts);
  const Kind& kd = block_kind(ch);
  const int length = kd.steps + kd.depth;

  if (GROUP) {
    const int e = threadIdx.x % pc::G;
    const Lane ln = lane_of(ch, kd, pc::LANES, threadIdx.x / pc::G);
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
  } else {
    const Lane ln = lane_of(ch, kd, pc::LANE_THREADS, threadIdx.x);
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

// The descriptor's words into ch, each kind's blocks of `per_block` chains
// after the last's; returns the grid's blocks, or -1 on a malformed
// descriptor.
long long parse(const long long* d, int per_block, Chains& ch) {
  const long long kinds = d[0], B = d[1], Q = d[2], n_out = d[3];
  if (kinds < 1 || kinds > MAX_KINDS || B < 0 || Q < 1 || Q > (1 << 30) ||
      n_out < kinds || n_out > MAX_KINDS)
    return -1;
  ch.lanes = B * Q;
  ch.q = (int)Q;
  ch.kinds = (int)kinds;
  ch.n_out = (int)n_out;
  for (int w = 0; w < 2; ++w) {
    ch.idx[w] = (const long long*)d[4 + 3 * w];
    ch.idx_stride[w][0] = d[5 + 3 * w];
    ch.idx_stride[w][1] = d[6 + 3 * w];
  }
  const long long per_kind = (ch.lanes + per_block - 1) / per_block;
  long long blocks = 0;
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
    kd.first_block = (int)blocks;
    blocks += per_kind;
  }
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

bool smem_set[pb_a::MAX_DEVICES] = {};

}  // namespace

// desc: the host descriptor's words (HEAD, then KIND_WORDS a kind, kinds in
// launch order); out: (B, Q, n_out, 16) int64, contiguous, on the device;
// consts, mats: kernel A's tables (kernels/poseidon_bn254._kernel_tables).
// Returns the first CUDA error, else 0.
extern "C" int p2t_merkle_chains_a(const long long* desc, void* out,
                                   const void* consts, const void* mats,
                                   void* stream) {
  Chains ch;
  const long long blocks = parse(desc, pb_a::TILE, ch);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  const int err = pb_a::allow_smem(merkle_chains_a_kernel, smem_set);
  if (err) return err;
  if (blocks > 0)
    merkle_chains_a_kernel<<<(unsigned)blocks, pb_a::TILE, pb_a::SMEM,
                             (cudaStream_t)stream>>>(
        ch, (long long*)out, (const u32*)consts, (const uint8_t*)mats);
  return (int)cudaGetLastError();
}

// As p2t_merkle_chains_a, with the CIOS kernel's constants
// (kernels/poseidon_bn254_cios._kernel_consts): the group form below two
// warps an SM of chains, the lane form above, as the CIOS kernel picks.
extern "C" int p2t_merkle_chains_cios(const long long* desc, void* out,
                                      const void* consts, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  Chains ch;
  const long long chains = desc[0] * desc[1] * desc[2];
  const bool group = chains < (long long)pb_cios::GROUP_BELOW * sms;
  const long long blocks =
      parse(desc, group ? pb_cios::LANES : pb_cios::LANE_THREADS, ch);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (blocks > 0) {
    if (group)
      merkle_chains_cios_kernel<true><<<(unsigned)blocks, pb_cios::THREADS, 0, st>>>(
          ch, (long long*)out, (const uint32_t*)consts);
    else
      merkle_chains_cios_kernel<false><<<(unsigned)blocks, pb_cios::LANE_THREADS, 0, st>>>(
          ch, (long long*)out, (const uint32_t*)consts);
  }
  return (int)cudaGetLastError();
}
