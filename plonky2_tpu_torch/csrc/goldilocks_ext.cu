// The verifier's sequential quadratic-extension chains for Hopper (sm_90a):
// Horner evaluation and powers, each lane's chain split over a group of
// threads, and the inverse, one thread an element, over F_p[X]/(X^2 - 7),
// p = 2^64 - 2^32 + 1.
//
// Replaces the JAX package's jax.lax.scan chains (no Pallas kernel; under
// jit each scan is one device loop):
// - qe_horner_kernel: plonky2_tpu/fields/goldilocks_ext.py horner (:209-227,
//   the scan at :226): acc = acc x + t_i for i from n-1 down to 0;
// - qe_powers_kernel: goldilocks_ext.py powers (:230-243, the scan at
//   :237): [1, x, .., x^(n-1)];
// - qe_inv_kernel: goldilocks_ext.py inv (:132) through
//   plonky2_tpu/fields/goldilocks.py inv (:345-366, an MSB-first
//   square-and-multiply scan at :365): conj(a) / N(a), 0 for 0.
// The port's plain versions are fields/goldilocks_ext.py horner_plain,
// powers_plain and inv_plain; the values are canonical and field arithmetic
// is exact, so the kernels are bit-exact with them whatever order they sum
// in.
//
// Layout: the port's representation, read and written as it is.  A QE
// value is four int64 planes of 32-bit halves, (lo0, hi0, lo1, hi1); the
// kernel assembles u64 = lo | hi << 32 and splits its results back, so no
// torch op packs or unpacks.  Horner's terms and the powers are (L, n)
// row-major, as the call sites make and read them; the wrapper broadcasts
// and makes the planes contiguous, and transposes nothing.
//
// What bounds it on the H100: on the main path (B = 256) the chains have
// 256 to 7,168 lanes and n = 2 to 258, and bytes (2.1 MB of terms at
// (256, 258)) and IMADs are far below a microsecond, so Horner and powers
// are bound by the latency of their dependent QE products.  The first
// design ran one thread a lane, n steps deep: at 256 lanes that is 4 blocks
// of 64 threads on 4 of the 132 SMs, neighbouring threads reading n words
// apart, and at about 270 ns a step (one warp a sub-partition) 258 steps
// took 0.069 ms.
//
// The design now: a lane's chain is split over a group of G threads, G a
// power of two from 1 to 32 that the wrapper chooses (kernels/goldilocks_ext
// .chain_group) and passes; a group never straddles a warp.  Thread j < G of
// a lane's group
// - makes y = x^G by log2 G squarings and x^j from the same squarings
//   (x^(2^s) multiplied in where bit s of j is set, by 1 where it is not, so
//   a group does not diverge);
// - Horner: sum_i t_i x^i = sum_j x^j Q_j(x^G), Q_j holding t_(j + G k):
//   runs Horner in y over its own terms, ceil(n / G) dependent steps, the G
//   threads of a group reading G neighbouring terms of the row in a step
//   (terms fetched a chunk of steps ahead of the chain); multiplies by x^j;
//   the group sums its results with __shfl_xor_sync on the 64-bit words, a
//   tree of log2 G additions, and thread 0 stores;
// - powers: writes x^(j + G k), k = 0, 1, .., one product by y a step, so a
//   group writes G neighbouring outputs of the row in each plane.
// The chain goes from n products deep to about log2 G + ceil(n / G) + 1.
// Blocks are a whole number of warps, about lanes x G / SMs threads each
// (32 to 256), so that a launch spreads over the SMs.
//
// The inverse is 75 dependent products deep (3 for the norm, 71 in gl_inv's
// addition chain, 1 for the scaling) and takes 14 products and 65 squarings
// an element, so on (256, 28, 16) = 114,688 elements it also has an IMAD
// throughput bound (both counted in chip_smoke.py); it runs one thread an
// element in blocks of 64.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 64;        // the inverse's blocks
constexpr int MAX_GROUP = 32;      // a group lies inside one warp
constexpr int MAX_BLOCK = 256;     // the chains' largest block
constexpr int CHUNK = 2;           // Horner's terms fetched ahead, in steps

// A QE array as its four planes of int64 32-bit halves.
struct Planes {
  long long* lo0;
  long long* hi0;
  long long* lo1;
  long long* hi1;
};

__device__ __forceinline__ u64 join(const long long* lo, const long long* hi,
                                    size_t i) {
  return (u64)lo[i] | ((u64)hi[i] << 32);
}

__device__ __forceinline__ Qe load(const Planes& a, size_t i) {
  return Qe{join(a.lo0, a.hi0, i), join(a.lo1, a.hi1, i)};
}

__device__ __forceinline__ void store(const Planes& a, size_t i, Qe v) {
  a.lo0[i] = (long long)(v.c0 & EPSILON);
  a.hi0[i] = (long long)(v.c0 >> 32);
  a.lo1[i] = (long long)(v.c1 & EPSILON);
  a.hi1[i] = (long long)(v.c1 >> 32);
}

// The lanes of this thread's group of g (a power of two <= 32) in its warp.
__device__ __forceinline__ unsigned group_mask(int g) {
  if (g == MAX_GROUP) return 0xFFFFFFFFu;
  return ((1u << g) - 1) << ((threadIdx.x & 31) & ~(g - 1));
}

// a^2 = (a0^2 + a1 a1w) + 2 a0 a1 X, a1w = W a1 given: 3 products.
__device__ __forceinline__ Qe qe_sqr_w(Qe a, u64 a1w) {
  const u64 t = gl_mul(a.c0, a.c1);
  return Qe{gl_add(gl_mul(a.c0, a.c0), gl_mul(a.c1, a1w)), gl_add(t, t)};
}

// The group's powers of x for thread j < g: y = x^g by log2 g squarings,
// and x^j, into which each x^(2^s) is multiplied where bit s of j is set and
// 1 where it is not, so a group does not diverge.  W c1 is made once for
// each x^(2^s) and serves its squaring and its product (y1w = W y1).
struct GroupPowers {
  Qe xj, y;
  u64 y1w;
};

__device__ __forceinline__ GroupPowers group_powers(Qe x, int j, int g) {
  const Qe one{1, 0};
  Qe base = x;
  u64 b1w = gl_mul(x.c1, W);
  Qe acc = (j & 1) ? x : one;
#pragma unroll 1
  for (int s = 2; s <= g; s <<= 1) {
    base = qe_sqr_w(base, b1w);  // x^s
    b1w = gl_mul(base.c1, W);
    if (s < g) {
      const bool bit = j & s;
      acc = qe_mul_w(acc, bit ? base : one, bit ? b1w : 0);
    }
  }
  return GroupPowers{acc, base, b1w};
}

// The thread's lane and its place j in the lane's group, from g's log.
struct Slot {
  int lane, j;
};

__device__ __forceinline__ Slot slot(int log_g) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  return Slot{t >> log_g, t & ((1 << log_g) - 1)};
}

// out[l] = sum_i terms[l, i] x[l]^i, by a group of g = 2^log_g threads a
// lane.  Thread j's term of step k is i = j + g k; a step multiplies by
// y = x^g, from k = ceil(n / g) - 1 down to 0.
__global__ void __launch_bounds__(MAX_BLOCK)
qe_horner_kernel(Planes terms, Planes x, Planes out, int lanes, int n,
                 int log_g) {
  const int g = 1 << log_g;
  const Slot s = slot(log_g);
  if (s.lane >= lanes) return;  // a whole group: blocks are whole warps
  const unsigned mask = group_mask(g);
  const size_t row = (size_t)s.lane * n;
  auto fetch = [&](int k) -> Qe {
    const int i = s.j + g * k;
    return (k >= 0 && i < n) ? load(terms, row + i) : Qe{0, 0};
  };
  // the first chunk's terms are on their way while the powers are made
  Qe buf[CHUNK];
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) buf[c] = fetch((n + g - 1) / g - 1 - c);
  const GroupPowers gp = group_powers(load(x, s.lane), s.j, g);
  const u64 xj1w = gl_mul(gp.xj.c1, W);
  Qe acc{0, 0};
#pragma unroll 1
  for (int k = (n + g - 1) / g - 1; k >= 0; k -= CHUNK) {
    Qe next[CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) next[c] = fetch(k - CHUNK - c);
#pragma unroll
    for (int c = 0; c < CHUNK; ++c)
      if (k - c >= 0) acc = qe_add(qe_mul_w(acc, gp.y, gp.y1w), buf[c]);
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) buf[c] = next[c];
  }
  if (g > 1) acc = qe_mul_w(acc, gp.xj, xj1w);
#pragma unroll 1
  for (int off = g >> 1; off > 0; off >>= 1)
    acc = qe_add(acc, Qe{__shfl_xor_sync(mask, acc.c0, off, g),
                         __shfl_xor_sync(mask, acc.c1, off, g)});
  if (s.j == 0) store(out, s.lane, acc);
}

// out[l, i] = x[l]^i, i < n, by a group of g = 2^log_g threads a lane:
// thread j writes i = j + g k, k = 0, 1, .., multiplying by y = x^g.
__global__ void __launch_bounds__(MAX_BLOCK)
qe_powers_kernel(Planes x, Planes out, int lanes, int n, int log_g) {
  const int g = 1 << log_g;
  const Slot s = slot(log_g);
  if (s.lane >= lanes) return;
  const GroupPowers gp = group_powers(load(x, s.lane), s.j, g);
  Qe p = gp.xj;
  const size_t row = (size_t)s.lane * n;
#pragma unroll 1
  for (int i = s.j; i < n; i += g) {
    store(out, row + i, p);
    p = qe_mul_w(p, gp.y, gp.y1w);
  }
}

// out[e] = a[e]^-1, 0 for 0
__global__ void __launch_bounds__(THREADS)
qe_inv_kernel(Planes a, Planes out, int elements) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= elements) return;
  store(out, e, qe_inv(load(a, e)));
}

Planes planes(void* lo0, void* hi0, void* lo1, void* hi1) {
  return Planes{(long long*)lo0, (long long*)hi0, (long long*)lo1,
                (long long*)hi1};
}

int blocks(int lanes) { return (lanes + THREADS - 1) / THREADS; }

// log2 g for a power of two g in [1, MAX_GROUP], else -1.
int group_log(int g) {
  for (int s = 0; (1 << s) <= MAX_GROUP; ++s)
    if (g == 1 << s) return s;
  return -1;
}

// A chain launch of lanes x 2^log_g threads: blocks of whole warps, about
// one block an SM up to MAX_BLOCK threads.
struct ChainLaunch {
  int grid, block;
};

ChainLaunch chain_launch(int lanes, int log_g) {
  int device = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long threads = (long long)lanes << log_g;
  long long block = (threads + sms - 1) / sms;
  block = (block + 31) / 32 * 32;
  block = block < 32 ? 32 : (block > MAX_BLOCK ? MAX_BLOCK : block);
  return ChainLaunch{(int)((threads + block - 1) / block), (int)block};
}

}  // namespace

// Every array is int64 32-bit halves, contiguous: terms (lanes, n), x
// (lanes), out (lanes); g threads a lane, a power of two from 1 to 32.
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for
// another g.
extern "C" int p2t_qe_horner(void* t_lo0, void* t_hi0, void* t_lo1, void* t_hi1,
                             void* x_lo0, void* x_hi0, void* x_lo1, void* x_hi1,
                             void* o_lo0, void* o_hi0, void* o_lo1, void* o_hi1,
                             int lanes, int n, int g, void* stream) {
  const int log_g = group_log(g);
  if (log_g < 0) return (int)cudaErrorInvalidValue;
  if (lanes > 0) {
    const ChainLaunch c = chain_launch(lanes, log_g);
    qe_horner_kernel<<<c.grid, c.block, 0, (cudaStream_t)stream>>>(
        planes(t_lo0, t_hi0, t_lo1, t_hi1), planes(x_lo0, x_hi0, x_lo1, x_hi1),
        planes(o_lo0, o_hi0, o_lo1, o_hi1), lanes, n, log_g);
  }
  return (int)cudaGetLastError();
}

// x (lanes), out (lanes, n); g as for p2t_qe_horner.  Returns
// cudaGetLastError() after the launch.
extern "C" int p2t_qe_powers(void* x_lo0, void* x_hi0, void* x_lo1, void* x_hi1,
                             void* o_lo0, void* o_hi0, void* o_lo1, void* o_hi1,
                             int lanes, int n, int g, void* stream) {
  const int log_g = group_log(g);
  if (log_g < 0) return (int)cudaErrorInvalidValue;
  if (lanes > 0 && n > 0) {
    const ChainLaunch c = chain_launch(lanes, log_g);
    qe_powers_kernel<<<c.grid, c.block, 0, (cudaStream_t)stream>>>(
        planes(x_lo0, x_hi0, x_lo1, x_hi1), planes(o_lo0, o_hi0, o_lo1, o_hi1),
        lanes, n, log_g);
  }
  return (int)cudaGetLastError();
}

// a, out (elements).  Returns cudaGetLastError() after the launch.
extern "C" int p2t_qe_inv(void* a_lo0, void* a_hi0, void* a_lo1, void* a_hi1,
                          void* o_lo0, void* o_hi0, void* o_lo1, void* o_hi1,
                          int elements, void* stream) {
  if (elements > 0)
    qe_inv_kernel<<<blocks(elements), THREADS, 0, (cudaStream_t)stream>>>(
        planes(a_lo0, a_hi0, a_lo1, a_hi1), planes(o_lo0, o_hi0, o_lo1, o_hi1),
        elements);
  return (int)cudaGetLastError();
}
