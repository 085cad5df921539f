// The PLONK stage's field arithmetic for Hopper (sm_90a): elementwise
// Goldilocks and quadratic-extension products over broadcast operands, and
// the coset-interpolation gate's chunk scan, p = 2^64 - 2^32 + 1.
//
// Replaces what the JAX package runs as fused XLA loops on its device
// (there is no Pallas kernel for them):
// - gl_mul_kernel: plonky2_tpu/fields/goldilocks.py mul (:293), a b;
// - gl_mul_const_kernel: goldilocks.py mul_const (:297), a c for a constant
//   c passed by value (c = 0 and c = 1 never launch: the wrapper's caller
//   returns zeros or a);
// - qe_mul_kernel: plonky2_tpu/fields/goldilocks_ext.py mul (:59) and
//   mul_add (:67), a b and a b + c over F_p[X]/(X^2 - 7);
// - coset_interp_scan_kernel: the jax.lax.scan of
//   plonky2_tpu/gates/gates.py CosetInterpolationGate.eval (:293, body
//   :279-291): per (lane, chunk), deg steps of
//     term = pt - x_j (base coordinate of the first QE only),
//     ev' = ev term + (val_j w_j) pr,  pr' = pr term,
//   each kept only where active[j, c], over the extension algebra
//   (QE[Y]/(Y^2 - 7), ea_mul in goldilocks.cuh).
// The port's plain versions are fields/goldilocks.py mul_plain and
// mul_const_plain, fields/goldilocks_ext.py mul_plain and mul_add_plain, and
// gates/gates.py coset_interp_scan_plain; the values are canonical, so the
// kernels are bit-exact with them.
//
// Layout: the port's representation, read where it lies.  A GL value is two
// int64 planes of 32-bit halves (lo, hi), a QE value four, an EA value
// eight; the planes of one operand may have different shapes and strides
// (a view of a wire column beside a fresh tensor).  The wrapper
// (kernels/goldilocks_mul.py) broadcasts the operands to the lead shape
// without copying: it passes each plane's pointer and its element strides,
// 0 along a broadcast axis, over at most MAX_DIMS dimensions (size-1 axes
// dropped, axes that every plane walks contiguously merged), in a host
// array of int64 words that the C entry copies into the kernel's by-value
// argument.  Outputs are one contiguous allocation of 2 or 4 planes.
//
// What bounds it on the H100: at the main path's shapes (B = 256) a
// product has 256 to some 10^5 elements.  Bytes set the bound: a QE
// product reads 64 B and writes 32 B an element (a GL product 32 and 16),
// against 4 to 16 dependent 64-bit products (8 IMADs each) a thread.  But
// at these sizes a launch is a few microseconds of fixed cost, far above
// either bound; what the kernels save is the ~146 int64 torch ops a product
// that the plain version issues.  The scan is latency-bound: deg dependent
// steps of three EA products (12 QE products, about 3 dependent GL
// products deep each) on B x C threads.  A simple kernel first: one thread
// an element (a lane and chunk for the scan), 128-thread blocks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_DIMS = 4;
// Words of the host descriptor before the planes: n, ndim, dims[MAX_DIMS].
constexpr int HEAD = 2 + MAX_DIMS;
// Words a plane: its pointer, then its strides.
constexpr int PLANE = 1 + MAX_DIMS;

// NP input planes walked over one broadcast lead shape.
template <int NP>
struct Strided {
  long long n;
  int ndim;
  long long dims[MAX_DIMS];
  const long long* ptr[NP];
  long long stride[NP][MAX_DIMS];
};

template <int NP>
Strided<NP> strided(const long long* desc, int planes) {
  Strided<NP> s;
  s.n = desc[0];
  s.ndim = (int)desc[1];
  for (int d = 0; d < MAX_DIMS; ++d) s.dims[d] = desc[2 + d];
  for (int k = 0; k < NP; ++k) {
    const long long* p = desc + HEAD + PLANE * (k < planes ? k : 0);
    s.ptr[k] = (const long long*)p[0];
    for (int d = 0; d < MAX_DIMS; ++d) s.stride[k][d] = p[1 + d];
  }
  return s;
}

// The offsets of element e in each of the first `planes` planes.
template <int NP>
__device__ __forceinline__ void offsets(const Strided<NP>& s, long long e,
                                        long long* off) {
  long long coord[MAX_DIMS];
#pragma unroll
  for (int d = MAX_DIMS - 1; d >= 0; --d) {
    if (d < s.ndim) {
      coord[d] = e % s.dims[d];
      e /= s.dims[d];
    } else {
      coord[d] = 0;
    }
  }
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    long long o = 0;
#pragma unroll
    for (int d = 0; d < MAX_DIMS; ++d) o += coord[d] * s.stride[k][d];
    off[k] = o;
  }
}

__device__ __forceinline__ u64 join(const long long* lo, const long long* hi,
                                    long long i, long long j) {
  return (u64)lo[i] | ((u64)hi[j] << 32);
}

__device__ __forceinline__ void split(long long* out, long long n, int plane,
                                      long long e, u64 v) {
  out[plane * n + e] = (long long)(v & EPSILON);
  out[(plane + 1) * n + e] = (long long)(v >> 32);
}

// planes: a.lo, a.hi, b.lo, b.hi; out (2, n)
__global__ void __launch_bounds__(THREADS)
gl_mul_kernel(Strided<4> s, long long* out) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= s.n) return;
  long long o[4];
  offsets(s, e, o);
  const u64 a = join(s.ptr[0], s.ptr[1], o[0], o[1]);
  const u64 b = join(s.ptr[2], s.ptr[3], o[2], o[3]);
  split(out, s.n, 0, e, gl_mul(a, b));
}

// planes: a.lo, a.hi; out (2, n)
__global__ void __launch_bounds__(THREADS)
gl_mul_const_kernel(Strided<2> s, u64 c, long long* out) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= s.n) return;
  long long o[2];
  offsets(s, e, o);
  split(out, s.n, 0, e, gl_mul(join(s.ptr[0], s.ptr[1], o[0], o[1]), c));
}

__device__ __forceinline__ Qe load_qe(const long long* const* p,
                                      const long long* o) {
  return Qe{join(p[0], p[1], o[0], o[1]), join(p[2], p[3], o[2], o[3])};
}

// planes: a (4), b (4), then c (4) when add; out (4, n)
__global__ void __launch_bounds__(THREADS)
qe_mul_kernel(Strided<12> s, int add, long long* out) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= s.n) return;
  long long o[12];
  offsets(s, e, o);
  const Qe a = load_qe(s.ptr, o);
  const Qe b = load_qe(s.ptr + 4, o + 4);
  Qe r = qe_mul(a, b);
  if (add) r = qe_add(r, load_qe(s.ptr + 8, o + 8));
  split(out, s.n, 0, e, r.c0);
  split(out, s.n, 2, e, r.c1);
}

// -- the coset-interpolation chunk scan -------------------------------------

// Planes, each with strides over (lane, step, chunk): ev (8), pr (8), val
// (8), pt (8), xs (2), ws (2), active (1, bytes).
constexpr int SCAN_PLANES = 37;
constexpr int SCAN_PLANE = 4;  // pointer, three strides
enum { EV = 0, PR = 8, VAL = 16, PT = 24, XS = 32, WS = 34, ACT = 36 };

struct Scan {
  int lanes, deg, chunks;
  const long long* ptr[SCAN_PLANES];
  long long stride[SCAN_PLANES][3];
};

__device__ __forceinline__ long long at(const Scan& s, int k, int b, int j,
                                        int c) {
  return s.stride[k][0] * b + s.stride[k][1] * j + s.stride[k][2] * c;
}

__device__ __forceinline__ u64 load_gl(const Scan& s, int k, int b, int j,
                                       int c) {
  return join(s.ptr[k], s.ptr[k + 1], at(s, k, b, j, c),
              at(s, k + 1, b, j, c));
}

__device__ __forceinline__ Ea load_ea(const Scan& s, int k, int b, int j,
                                      int c) {
  return Ea{Qe{load_gl(s, k, b, j, c), load_gl(s, k + 2, b, j, c)},
            Qe{load_gl(s, k + 4, b, j, c), load_gl(s, k + 6, b, j, c)}};
}

// out (16, lanes, chunks): ev's eight planes, then pr's
__global__ void __launch_bounds__(THREADS)
coset_interp_scan_kernel(Scan s, long long* out) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= s.lanes * s.chunks) return;
  const int b = t / s.chunks;
  const int c = t % s.chunks;
  Ea ev = load_ea(s, EV, b, 0, c);
  Ea pr = load_ea(s, PR, b, 0, c);
  const Ea pt = load_ea(s, PT, b, 0, c);
  const unsigned char* act = (const unsigned char*)s.ptr[ACT];
#pragma unroll 1
  for (int j = 0; j < s.deg; ++j) {
    if (!act[at(s, ACT, b, j, c)]) continue;
    const u64 x = load_gl(s, XS, b, j, c);
    const u64 w = load_gl(s, WS, b, j, c);
    const Ea v = load_ea(s, VAL, b, j, c);
    const Ea term{Qe{gl_sub(pt.a.c0, x), pt.a.c1}, pt.b};
    const Ea wv{Qe{gl_mul(v.a.c0, w), gl_mul(v.a.c1, w)},
                Qe{gl_mul(v.b.c0, w), gl_mul(v.b.c1, w)}};
    const Ea next = ea_add(ea_mul(ev, term), ea_mul(wv, pr));
    pr = ea_mul(pr, term);
    ev = next;
  }
  const long long n = (long long)s.lanes * s.chunks;
  split(out, n, 0, t, ev.a.c0);
  split(out, n, 2, t, ev.a.c1);
  split(out, n, 4, t, ev.b.c0);
  split(out, n, 6, t, ev.b.c1);
  split(out, n, 8, t, pr.a.c0);
  split(out, n, 10, t, pr.a.c1);
  split(out, n, 12, t, pr.b.c0);
  split(out, n, 14, t, pr.b.c1);
}

unsigned blocks(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// desc: n, ndim, dims[4], then per input plane its pointer and 4 element
// strides (int64 words, host memory, read before the launch returns); out:
// (2, n) or (4, n) int64, contiguous.  n > 0.  Each returns
// cudaGetLastError() after the launch.
extern "C" int p2t_gl_mul(const long long* desc, void* out, void* stream) {
  const Strided<4> s = strided<4>(desc, 4);
  gl_mul_kernel<<<blocks(s.n), THREADS, 0, (cudaStream_t)stream>>>(
      s, (long long*)out);
  return (int)cudaGetLastError();
}

extern "C" int p2t_gl_mul_const(const long long* desc, unsigned long long c,
                                void* out, void* stream) {
  const Strided<2> s = strided<2>(desc, 2);
  gl_mul_const_kernel<<<blocks(s.n), THREADS, 0, (cudaStream_t)stream>>>(
      s, c, (long long*)out);
  return (int)cudaGetLastError();
}

// add: 1 for a b + c (12 planes in desc), 0 for a b (8 planes).
extern "C" int p2t_qe_mul(const long long* desc, int add, void* out,
                          void* stream) {
  const Strided<12> s = strided<12>(desc, add ? 12 : 8);
  qe_mul_kernel<<<blocks(s.n), THREADS, 0, (cudaStream_t)stream>>>(
      s, add, (long long*)out);
  return (int)cudaGetLastError();
}

// desc: lanes, deg, chunks, then per plane (SCAN_PLANES, in the order of the
// enum above) its pointer and strides over (lane, step, chunk); out (16,
// lanes, chunks) int64, contiguous.  lanes x chunks > 0.
extern "C" int p2t_coset_interp_scan(const long long* desc, void* out,
                                     void* stream) {
  Scan s;
  s.lanes = (int)desc[0];
  s.deg = (int)desc[1];
  s.chunks = (int)desc[2];
  for (int k = 0; k < SCAN_PLANES; ++k) {
    const long long* p = desc + 3 + SCAN_PLANE * k;
    s.ptr[k] = (const long long*)p[0];
    for (int d = 0; d < 3; ++d) s.stride[k][d] = p[1 + d];
  }
  coset_interp_scan_kernel<<<blocks((long long)s.lanes * s.chunks), THREADS,
                             0, (cudaStream_t)stream>>>(s, (long long*)out);
  return (int)cudaGetLastError();
}
