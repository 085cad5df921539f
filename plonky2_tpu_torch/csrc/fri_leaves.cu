// FRI's Merkle-leaf absorb blocks for Hopper (sm_90a), built on the card from
// the batch's Goldilocks leaves.
//
// Replaces no TPU kernel: the JAX package packs these blocks on the host at
// ingest (plonky2_tpu/proof/serde.py, _pack_leaf_mont) and ships them beside
// the leaves, as the port did.  Those blocks were two thirds of the bytes a
// step batch packs into its pinned buffer and copies to the card (PERF.md,
// §6); the leaves themselves are on the card already, where FRI's evaluation
// check reads them.  So the compiled verifier builds the blocks here, inside
// its graph, right before FRI's chain kernels (fri_merkle.cu) read them.
//
// A leaf of n Goldilocks elements (an initial oracle's, or a reduction
// step's evals read c0, c1 an eval) fills absorb blocks of 3 slots; slot s of
// block t packs elements 9 t + 3 s .. 9 t + 3 s + 2 (zeros past the last)
// into one integer, sum v_k 2^(64 k), below 2^192 < p, and holds it in
// Montgomery form as 16 limbs of 16 bits in int64 words
// (reference poseidon/bn254.go:47-77; fri/merkle.pack_blocks_plain).  One
// Montgomery product by R^2 mod p (bn254_mont.cuh) takes x to x R mod p; x
// is below p, so the product's one conditional subtraction leaves the
// canonical residue.  Empty slots and steps come out zero, as ingest leaves
// them.
//
// What bounds it on the H100: the bytes it writes.  A thread makes one
// element (one slot of one block of one lane): up to 6 words read, one
// product of 8 x 8 words (some 260 IMADs), 128 bytes written.  A step batch
// of 256 is 1.55 million elements: 198 MB written and 37 MB of int64 words
// read, 0.070 ms at 3.35 TB/s; its IMADs take 0.024 ms at the card's rate.
// Every output element is one thread, so every SM is busy from the first
// block.  A block's elements go through shared memory and out as 16-byte
// chunks that neighbouring threads write side by side: a thread writing its
// own element's 128 bytes, 8 stores 128 bytes apart across the warp, took
// 0.444 ms at step B=256 (PERF.md, §6).  The sources go by value
// (__grid_constant__ Leaves)
// with each word plane's strides: the leaves are read where they lie (views
// of the batch, a query window) and the launch reads nothing on the card for
// itself, so a CUDA graph can capture it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_mont.cuh"

namespace {

constexpr int MAX_SOURCES = 8;  // leaves a launch takes
constexpr int THREADS = 128;    // a block's threads
// The host descriptor's words (kernels/fri_leaves.descriptor): the head,
// then SOURCE_WORDS a source.
constexpr int HEAD = 3 + NW;     // sources, B, Q, R^2 mod p's 8 words
constexpr int SOURCE_WORDS = 21;  // out ptr, out lane stride, steps, n,
                                  // comps, 4 planes x (ptr, b, q, e stride)

// One word plane of a leaf's elements: (B, Q, n / comps) int64 words.
struct Plane {
  const long long* ptr;
  long long stride[3];  // b, q, element
};

// One leaf over the (B, Q) lanes.
struct Source {
  long long* out;        // its blocks: lane c at out + c * lane, (steps, 3, 16)
  long long lane;        // elements between two lanes' blocks
  unsigned first;        // the launch's thread of its first element
  int steps, n, comps;   // blocks, elements, components an index (1 or 2)
  Plane plane[4];        // lo, hi of component 0, then of component 1
};

struct Leaves {
  unsigned q;           // Q
  unsigned total;       // elements (threads) of the launch
  int sources;
  Fe r2;                // R^2 mod p
  Source src[MAX_SOURCES];
};

__device__ __forceinline__ u32 word_at(const Plane& pl, long long b, long long q,
                                       long long e) {
  return (u32)pl.ptr[b * pl.stride[0] + q * pl.stride[1] + e * pl.stride[2]];
}

__global__ void __launch_bounds__(THREADS)
fri_leaf_blocks_kernel(const __grid_constant__ Leaves lv) {
  __shared__ u32 words[THREADS][NW + 1];  // odd row stride: no bank conflict
  __shared__ long long* dst[THREADS];
  // 32-bit index arithmetic: parse keeps the launch below 2^31 elements
  const unsigned e = blockIdx.x * THREADS + threadIdx.x;
  dst[threadIdx.x] = nullptr;
  if (e < lv.total) {
    int k = 0;
#pragma unroll 1
    while (k + 1 < lv.sources && e >= lv.src[k + 1].first) ++k;
    const Source& s = lv.src[k];
    const unsigned per_lane = 3u * s.steps;
    const unsigned r = e - s.first;
    const unsigned c = r / per_lane;
    const int slot = (int)(r - c * per_lane);  // 3 t + s
    const unsigned b = c / lv.q, q = c - b * lv.q;
    Fe x;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int i = 3 * slot + j;  // the element: 9 t + 3 s + j
      u32 lo = 0, hi = 0;
      if (i < s.n) {
        const int comp = s.comps == 2 ? i & 1 : 0;
        const int at = s.comps == 2 ? i >> 1 : i;
        lo = word_at(s.plane[2 * comp], b, q, at);
        hi = word_at(s.plane[2 * comp + 1], b, q, at);
      }
      x.w[2 * j] = lo;
      x.w[2 * j + 1] = hi;
    }
    x.w[6] = x.w[7] = 0;
    u32 t[ACC];
    mont<true>(t, x, lv.r2);  // x R^2 / 2^256 = x R mod p, below 2p
    const Fe m = cond_sub(t, fe_p());
#pragma unroll
    for (int w = 0; w < NW; ++w) words[threadIdx.x][w] = m.w[w];
    dst[threadIdx.x] = s.out + (long long)c * s.lane + 16LL * slot;
  }
  __syncthreads();
  // The block's elements as 16-byte chunks of two limbs, NW an element:
  // thread u writes chunks u, u + THREADS, ..., so a warp writes whole
  // elements side by side (mostly one run of 512 bytes).
#pragma unroll
  for (int u = threadIdx.x; u < THREADS * NW; u += THREADS) {
    const int el = u / NW, w = u % NW;
    long long* d = dst[el];
    if (d) {
      const u32 v = words[el][w];
      reinterpret_cast<longlong2*>(d)[w] =
          make_longlong2((long long)(v & 0xffffu), (long long)(v >> 16));
    }
  }
}

// The descriptor's words into lv; returns the grid's blocks, or -1 on a
// malformed descriptor.
long long parse(const long long* d, Leaves& lv) {
  const long long sources = d[0], B = d[1], Q = d[2];
  if (sources < 1 || sources > MAX_SOURCES || B < 0 || Q < 1 || Q > (1 << 30))
    return -1;
  lv.q = (unsigned)Q;
  lv.sources = (int)sources;
  for (int w = 0; w < NW; ++w) lv.r2.w[w] = (u32)d[3 + w];
  long long total = 0;
  for (int k = 0; k < MAX_SOURCES; ++k) {
    Source& s = lv.src[k];
    s = Source{};
    if (k >= sources) continue;
    const long long* p = d + HEAD + SOURCE_WORDS * k;
    const long long steps = p[2], n = p[3], comps = p[4];
    if (steps < 1 || n < 1 || n > 9 * steps || (comps != 1 && comps != 2) ||
        n % comps || p[1] < 48 * steps || (p[0] & 15) || (p[1] & 1))
      return -1;
    s.out = (long long*)p[0];
    s.lane = p[1];
    s.steps = (int)steps;
    s.n = (int)n;
    s.comps = (int)comps;
    for (int i = 0; i < 2 * comps; ++i) {
      const long long* w = p + 5 + 4 * i;
      s.plane[i].ptr = (const long long*)w[0];
      for (int j = 0; j < 3; ++j) s.plane[i].stride[j] = w[1 + j];
    }
    s.first = (unsigned)total;
    total += B * Q * 3 * steps;
    if (total > 0x7fffffffLL) return -1;
  }
  lv.total = (unsigned)total;
  return (total + THREADS - 1) / THREADS;
}

}  // namespace

// desc: the host descriptor's words (HEAD: sources, B, Q, R^2 mod p as 8
// u32 words; SOURCE_WORDS a source: its blocks' pointer (16-byte aligned)
// and lane stride in elements, steps, elements, components an index, then
// for each of its 2 comps planes (lo, hi of c0, then of c1) a pointer and
// its b, q, element strides).  Returns the first CUDA error, else 0.
extern "C" int p2t_fri_leaf_blocks(const long long* desc, void* stream) {
  Leaves lv;
  const long long blocks = parse(desc, lv);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  if (blocks > 0)
    fri_leaf_blocks_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(lv);
  return (int)cudaGetLastError();
}
