// The verifier's sequential quadratic-extension chains, one thread a lane,
// for Hopper (sm_90a): Horner evaluation, powers and the inverse over
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
// powers_plain and inv_plain; the values are canonical, so the kernels are
// bit-exact with them.
//
// Layout: the port's representation, read and written as it is.  A QE
// value is four int64 planes of 32-bit halves, (lo0, hi0, lo1, hi1); the
// kernel assembles u64 = lo | hi << 32 and splits its results back, so no
// torch op packs or unpacks.  Horner's terms are (L, n) row-major, as the
// call sites make them: thread l walks its own row (neighbouring threads
// read n words apart, from rows that stay in L1 between steps); the wrapper
// broadcasts and makes the planes contiguous, and transposes nothing.
//
// What bounds it on the H100: on the main path (B = 256) the chains have
// 256 to 7,168 lanes, a few warps an SM at most, so Horner and powers are
// latency-bound: n dependent steps of one QE product and one add, about
// n x L with L = one dependent Goldilocks product (W x1 is computed once per
// lane, so a step waits on one product, not two; qe_mul_w in
// goldilocks.cuh).  The inverse is 75 dependent products deep (3 for the
// norm, 71 in gl_inv's addition chain, 1 for the scaling) and takes 14
// products and 65 squarings an element, so on (256, 28, 16) = 114,688
// elements it also has an IMAD throughput bound (both counted in
// chip_smoke.py).  Bytes are far below either: (256, 258) terms are 2.1 MB.
//
// A simple kernel first: blocks of 64 threads so that the few lanes spread
// over SMs; no split of a chain over threads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 64;

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

// out[l] = sum_i terms[l, i] x[l]^i
__global__ void __launch_bounds__(THREADS)
qe_horner_kernel(Planes terms, Planes x, Planes out, int lanes, int n) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= lanes) return;
  const Qe xv = load(x, l);
  const u64 x1w = gl_mul(xv.c1, W);
  Qe acc{0, 0};
  const size_t row = (size_t)l * n;
#pragma unroll 1
  for (int i = n - 1; i >= 0; --i)
    acc = qe_add(qe_mul_w(acc, xv, x1w), load(terms, row + i));
  store(out, l, acc);
}

// out[l, i] = x[l]^i, i < n
__global__ void __launch_bounds__(THREADS)
qe_powers_kernel(Planes x, Planes out, int lanes, int n) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= lanes) return;
  const Qe xv = load(x, l);
  const u64 x1w = gl_mul(xv.c1, W);
  Qe p{1, 0};
  const size_t row = (size_t)l * n;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    store(out, row + i, p);
    p = qe_mul_w(p, xv, x1w);
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

}  // namespace

// Every array is int64 32-bit halves, contiguous: terms (lanes, n), x
// (lanes), out (lanes).  Returns cudaGetLastError() after the launch.
extern "C" int p2t_qe_horner(void* t_lo0, void* t_hi0, void* t_lo1, void* t_hi1,
                             void* x_lo0, void* x_hi0, void* x_lo1, void* x_hi1,
                             void* o_lo0, void* o_hi0, void* o_lo1, void* o_hi1,
                             int lanes, int n, void* stream) {
  if (lanes > 0)
    qe_horner_kernel<<<blocks(lanes), THREADS, 0, (cudaStream_t)stream>>>(
        planes(t_lo0, t_hi0, t_lo1, t_hi1), planes(x_lo0, x_hi0, x_lo1, x_hi1),
        planes(o_lo0, o_hi0, o_lo1, o_hi1), lanes, n);
  return (int)cudaGetLastError();
}

// x (lanes), out (lanes, n).  Returns cudaGetLastError() after the launch.
extern "C" int p2t_qe_powers(void* x_lo0, void* x_hi0, void* x_lo1, void* x_hi1,
                             void* o_lo0, void* o_hi0, void* o_lo1, void* o_hi1,
                             int lanes, int n, void* stream) {
  if (lanes > 0 && n > 0)
    qe_powers_kernel<<<blocks(lanes), THREADS, 0, (cudaStream_t)stream>>>(
        planes(x_lo0, x_hi0, x_lo1, x_hi1), planes(o_lo0, o_hi0, o_lo1, o_hi1),
        lanes, n);
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
