// The verifier's sequential quadratic-extension chains for Hopper (sm_90a):
// Horner evaluation and powers, each lane's chain split over a group of
// threads, and the inverse, by batch inversion across a warp, over
// F_p[X]/(X^2 - 7), p = 2^64 - 2^32 + 1.
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
// or multiply in.
//
// Layout: the port's representation.  A QE value is four int64 planes of
// 32-bit halves, (lo0, hi0, lo1, hi1); the kernel assembles u64 = lo | hi <<
// 32 and splits its results back, so no torch op packs or unpacks.  Inputs
// are read where they lie, each plane by its element strides over the lead
// shape (strided.cuh; 0 along a broadcast axis, and for Horner's terms a
// stride along n too), so a broadcast x or terms costs no copy; outputs are
// contiguous: Horner's (lanes), the powers' (lanes, n) row-major, the
// inverse's the lead shape.
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
// The inverse: the first design ran one thread an element, each a whole
// gl_inv (64 squarings and 9 products) besides the norm and the scaling,
// about 79 products an element; on (256, 28, 16) = 114,688 elements that is
// instruction throughput, not latency (75 products deep).  Now a warp
// inverts the product of its 32 K norms once (Montgomery's batch
// inversion): an element costs about 8 products (the norm 3, the lane's
// running product 1, the walk back 2, the scaling 2), and a warp adds 10
// for its two scans and one gl_inv of its total, computed by all 32 lanes
// at once, so the inverse's 79 products are spread over 32 K elements.  K,
// the elements a thread (1, 2, 4 or 8), is the wrapper's choice
// (kernels/goldilocks_ext.inv_per_thread): more elements a warp spread the
// inverse thinner, fewer warps hide less latency.  The chain is about 90 +
// 2 K products deep a warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"
#include "strided.cuh"

namespace {

constexpr int MAX_GROUP = 32;      // a group lies inside one warp
constexpr int MAX_BLOCK = 256;     // the largest block
constexpr int CHUNK = 2;           // Horner's terms fetched ahead, in steps
constexpr int MAX_PER_THREAD = 8;  // the inverse's elements a thread
constexpr unsigned FULL = 0xFFFFFFFFu;

// A QE output as its four contiguous planes of int64 32-bit halves.
struct Planes {
  long long* lo0;
  long long* hi0;
  long long* lo1;
  long long* hi1;
};

// The Horner terms' element strides along n, a plane each (0 where a plane
// broadcasts along it).
struct Steps {
  long long d[4];
};

// The QE value of planes p[0..3] at offsets o[0..3] plus i steps.
__device__ __forceinline__ Qe load(const long long* const* p,
                                   const long long* o, long long i = 0,
                                   const long long* step = nullptr) {
  u64 h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = (u64)p[k][o[k] + (step ? i * step[k] : 0)];
  return Qe{h[0] | (h[1] << 32), h[2] | (h[3] << 32)};
}

__device__ __forceinline__ void store(const Planes& a, size_t i, Qe v) {
  a.lo0[i] = (long long)(v.c0 & EPSILON);
  a.hi0[i] = (long long)(v.c0 >> 32);
  a.lo1[i] = (long long)(v.c1 & EPSILON);
  a.hi1[i] = (long long)(v.c1 >> 32);
}

// The lanes of this thread's group of g (a power of two <= 32) in its warp.
__device__ __forceinline__ unsigned group_mask(int g) {
  if (g == MAX_GROUP) return FULL;
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
// y = x^g, from k = ceil(n / g) - 1 down to 0.  Planes of s: the terms'
// four over the lanes (their steps along n in step), then x's four.
__global__ void __launch_bounds__(MAX_BLOCK)
qe_horner_kernel(Strided<8> s, Steps step, Planes out, int n, int log_g) {
  const int g = 1 << log_g;
  const Slot sl = slot(log_g);
  if (sl.lane >= s.n) return;  // a whole group: blocks are whole warps
  const unsigned mask = group_mask(g);
  long long o[8];
  offsets(s, sl.lane, o);
  auto fetch = [&](int k) -> Qe {
    const int i = sl.j + g * k;
    return (k >= 0 && i < n) ? load(s.ptr, o, i, step.d) : Qe{0, 0};
  };
  // the first chunk's terms are on their way while the powers are made
  Qe buf[CHUNK];
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) buf[c] = fetch((n + g - 1) / g - 1 - c);
  const GroupPowers gp = group_powers(load(s.ptr + 4, o + 4), sl.j, g);
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
  if (sl.j == 0) store(out, sl.lane, acc);
}

// out[l, i] = x[l]^i, i < n, by a group of g = 2^log_g threads a lane:
// thread j writes i = j + g k, k = 0, 1, .., multiplying by y = x^g.
__global__ void __launch_bounds__(MAX_BLOCK)
qe_powers_kernel(Strided<4> s, Planes out, int n, int log_g) {
  const int g = 1 << log_g;
  const Slot sl = slot(log_g);
  if (sl.lane >= s.n) return;
  long long o[4];
  offsets(s, sl.lane, o);
  const GroupPowers gp = group_powers(load(s.ptr, o), sl.j, g);
  Qe p = gp.xj;
  const size_t row = (size_t)sl.lane * n;
#pragma unroll 1
  for (int i = sl.j; i < n; i += g) {
    store(out, row + i, p);
    p = qe_mul_w(p, gp.y, gp.y1w);
  }
}

// out[e] = a[e]^-1, 0 for 0, by batch inversion across a warp.  Lane l of
// warp w holds the K elements e = 32 K w + 32 j + l, j < K (neighbouring
// lanes on neighbouring elements).  Each element's norm N = a0^2 + W a1
// conj1 (conj1 = -a1) is 1 in place of 0 (N = 0 only for a = 0, whose a0
// and conj1 are 0, so its output is 0 whatever N^-1 stands for) and past
// the end.  A lane multiplies its K norms into q[K - 1]; the warp scans the
// lanes' products both ways with __shfl_up_sync / __shfl_down_sync (5 steps
// each) and every lane inverts the warp's total (the same gl_inv on all 32
// lanes: no divergence, no shared memory); total^-1 times the lanes' product
// before and after this one is q[K - 1]^-1, from which the lane walks its K
// elements backwards: N_j^-1 = q[K - 1 .. j + 1]^-1 q[j - 1].  Every lane of
// every warp reaches every shuffle (the grid is whole warps, none returns
// early).
template <int K>
__global__ void __launch_bounds__(MAX_BLOCK)
qe_inv_kernel(Strided<4> s, Planes out) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long first = warp * 32 * K + lane;
  u64 a0[K], c1[K], norm[K], q[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const long long e = first + 32 * j;
    Qe a{0, 0};
    if (e < s.n) {
      long long o[4];
      offsets(s, e, o);
      a = load(s.ptr, o);
    }
    a0[j] = a.c0;
    c1[j] = gl_sub(0, a.c1);
    const u64 nj = gl_add(gl_mul(a.c0, a.c0), gl_mul(gl_mul(a.c1, c1[j]), W));
    norm[j] = nj ? nj : 1;
    q[j] = j ? gl_mul(q[j - 1], norm[j]) : norm[j];
  }
  // inc: the product of lanes 0 .. lane; suf: of lanes lane .. 31
  u64 inc = q[K - 1], suf = q[K - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 up = __shfl_up_sync(FULL, inc, d);
    const u64 down = __shfl_down_sync(FULL, suf, d);
    inc = gl_mul(inc, lane >= d ? up : 1);
    suf = gl_mul(suf, lane + d < 32 ? down : 1);
  }
  const u64 total = __shfl_sync(FULL, inc, 31);
  const u64 before = __shfl_up_sync(FULL, inc, 1);
  const u64 after = __shfl_down_sync(FULL, suf, 1);
  u64 y = gl_mul(gl_mul(gl_inv(total), lane > 0 ? before : 1),
                 lane < 31 ? after : 1);  // q[K - 1]^-1
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    const u64 norm_inv = j ? gl_mul(y, q[j - 1]) : y;
    if (j) y = gl_mul(y, norm[j]);
    const long long e = first + 32 * j;
    if (e < s.n)
      store(out, e, Qe{gl_mul(a0[j], norm_inv), gl_mul(c1[j], norm_inv)});
  }
}

Planes planes(void* lo0, void* hi0, void* lo1, void* hi1) {
  return Planes{(long long*)lo0, (long long*)hi0, (long long*)lo1,
                (long long*)hi1};
}

// log2 g for a power of two g in [1, max], else -1.
int power_log(int g, int max) {
  for (int s = 0; (1 << s) <= max; ++s)
    if (g == 1 << s) return s;
  return -1;
}

// A launch of `threads` threads: blocks of whole warps, about one block an
// SM up to MAX_BLOCK threads.
struct Launch {
  int grid, block;
};

Launch launch_shape(long long threads) {
  int device = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long block = (threads + sms - 1) / sms;
  block = (block + 31) / 32 * 32;
  block = block < 32 ? 32 : (block > MAX_BLOCK ? MAX_BLOCK : block);
  return Launch{(int)((threads + block - 1) / block), (int)block};
}

template <int K>
void launch_inv(const Strided<4>& s, Planes out, cudaStream_t stream) {
  const long long warps = (s.n + 32 * K - 1) / (32 * K);
  const Launch c = launch_shape(warps * 32);
  qe_inv_kernel<K><<<c.grid, c.block, 0, stream>>>(s, out);
}

}  // namespace

// desc (strided.cuh): the terms' four planes over the lanes' lead shape
// (lanes = desc[0]), then x's four; steps: each terms plane's element
// stride along n; out (lanes) int64 32-bit halves, contiguous; g threads a
// lane, a power of two from 1 to 32.  Returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for another g.
extern "C" int p2t_qe_horner(const long long* desc, const long long* steps,
                             void* o_lo0, void* o_hi0, void* o_lo1, void* o_hi1,
                             int n, int g, void* stream) {
  const int log_g = power_log(g, MAX_GROUP);
  if (log_g < 0) return (int)cudaErrorInvalidValue;
  const Strided<8> s = strided<8>(desc, 8);
  if (s.n > 0) {
    Steps st;
    for (int k = 0; k < 4; ++k) st.d[k] = steps[k];
    const Launch c = launch_shape(s.n << log_g);
    qe_horner_kernel<<<c.grid, c.block, 0, (cudaStream_t)stream>>>(
        s, st, planes(o_lo0, o_hi0, o_lo1, o_hi1), n, log_g);
  }
  return (int)cudaGetLastError();
}

// desc: x's four planes over the lanes (lanes = desc[0]); out (lanes, n),
// contiguous; g as for p2t_qe_horner.  Returns cudaGetLastError() after the
// launch.
extern "C" int p2t_qe_powers(const long long* desc, void* o_lo0, void* o_hi0,
                             void* o_lo1, void* o_hi1, int n, int g,
                             void* stream) {
  const int log_g = power_log(g, MAX_GROUP);
  if (log_g < 0) return (int)cudaErrorInvalidValue;
  const Strided<4> s = strided<4>(desc, 4);
  if (s.n > 0 && n > 0) {
    const Launch c = launch_shape(s.n << log_g);
    qe_powers_kernel<<<c.grid, c.block, 0, (cudaStream_t)stream>>>(
        s, planes(o_lo0, o_hi0, o_lo1, o_hi1), n, log_g);
  }
  return (int)cudaGetLastError();
}

// desc: a's four planes (elements = desc[0]); out (elements), contiguous;
// per_thread elements a thread, 1, 2, 4 or 8.  Returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for another per_thread.
extern "C" int p2t_qe_inv(const long long* desc, void* o_lo0, void* o_hi0,
                          void* o_lo1, void* o_hi1, int per_thread,
                          void* stream) {
  const int log_k = power_log(per_thread, MAX_PER_THREAD);
  if (log_k < 0) return (int)cudaErrorInvalidValue;
  const Strided<4> s = strided<4>(desc, 4);
  const Planes out = planes(o_lo0, o_hi0, o_lo1, o_hi1);
  const cudaStream_t st = (cudaStream_t)stream;
  if (s.n > 0) {
    switch (log_k) {
      case 0: launch_inv<1>(s, out, st); break;
      case 1: launch_inv<2>(s, out, st); break;
      case 2: launch_inv<4>(s, out, st); break;
      default: launch_inv<8>(s, out, st); break;
    }
  }
  return (int)cudaGetLastError();
}
