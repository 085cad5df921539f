// The PLONK stage's field arithmetic for Hopper (sm_90a): elementwise
// Goldilocks and quadratic-extension products over broadcast operands, and
// the coset-interpolation gate's chunk scan, p = 2^64 - 2^32 + 1.
//
// Replaces what the JAX package runs as fused XLA loops on its device
// (there is no Pallas kernel for them):
// - gl_mul_kernel: plonky2_tpu/fields/goldilocks.py mul (:293), a b;
// - gl_mul_const_kernel: goldilocks.py mul_const (:297), a c for a constant
//   c passed by value (fields/goldilocks.mul_const launches nothing for c =
//   0 and 1); and the bit-selected chains of plonky2_tpu/fri/verify.py,
//   subgroup_x (:177-186) and cosetStart (:293-299), each one fused loop
//   under jit: a c prod_i (bit_(off + i)(idx) ? t_i : 1), a optional, t a
//   table of up to 64 constants by value (fields/goldilocks.mul_const_bits),
//   one launch where the port's plain loop issues a product and a select a
//   bit;
// - qe_mul_kernel: plonky2_tpu/fields/goldilocks_ext.py mul (:59) and
//   mul_add (:67), a b and a b + c over F_p[X]/(X^2 - 7);
// - coset_interp_scan_kernel: the jax.lax.scan of
//   plonky2_tpu/gates/gates.py CosetInterpolationGate.eval (:293, body
//   :279-291): per (lane, chunk), deg steps of
//     term = pt - x_j (base coordinate of the first QE only),
//     ev' = ev term + (val_j w_j) pr,  pr' = pr term,
//   each kept only where active[j, c], over the extension algebra
//   (QE[Y]/(Y^2 - 7), ea_mul in goldilocks.cuh).
// The port's plain versions are fields/goldilocks.py mul_plain,
// mul_const_plain and mul_const_bits_plain, fields/goldilocks_ext.py
// mul_plain and mul_add_plain, and gates/gates.py coset_interp_scan_plain;
// the values are canonical, so the kernels are bit-exact with them.
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
// argument (strided.cuh).  Outputs are one contiguous allocation of 2 or 4
// planes.
//
// What bounds it on the H100: at the main path's shapes (B = 256) a
// product has 256 to some 10^5 elements.  Bytes set the bound: a QE
// product reads 64 B and writes 32 B an element (a GL product 32 and 16),
// against 4 to 16 dependent 64-bit products (8 IMADs each) a thread.  But
// at these sizes a launch is a few microseconds of fixed cost, far above
// either bound; what the kernels save is the ~146 int64 torch ops a product
// that the plain version issues, and the bit-selected product does a whole
// chain of them in one launch.  The scan is latency-bound: deg dependent
// steps of three EA products (12 QE products, about 3 dependent GL
// products deep each) on B x C threads.  A simple kernel first: one thread
// an element (a lane and chunk for the scan), 128-thread blocks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"
#include "strided.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_BITS = 64;  // the product by a constant's selected factors

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

// The factors of a product by a constant that the bits of an index select:
// t[i] where bit off + i of the index is set, 1 where it is clear, i < n.
struct BitTable {
  u64 t[MAX_BITS];
  int off, n;
};

// out = a c prod_{i < n} (bit_(off + i)(idx) ? t_i : 1).  HAS_A: planes 0
// and 1 are a (else a = 1); HAS_IDX: the next two planes are idx (lo, hi)
// (else n = 0).  The selected factors go into two interleaved products, so
// that the chain is about n / 2 products deep; a lane multiplies by 1 where
// its bit is clear, so a warp does not diverge.  The table is read through
// the by-value argument's constant bank (__grid_constant__: no local copy
// for the loop's index).  out (2, n).
template <bool HAS_A, bool HAS_IDX>
__global__ void __launch_bounds__(THREADS)
gl_mul_const_kernel(Strided<4> s, u64 c, const __grid_constant__ BitTable bits,
                    long long* out) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= s.n) return;
  long long o[4];
  offsets(s, e, o);
  u64 v = HAS_A ? gl_mul(join(s.ptr[0], s.ptr[1], o[0], o[1]), c) : c;
  if (HAS_IDX) {
    constexpr int k = HAS_A ? 2 : 0;
    const u64 idx = join(s.ptr[k], s.ptr[k + 1], o[k], o[k + 1]) >> bits.off;
    u64 odd = 1;  // t[n] = 1 where n is odd (the C entry fills the table)
#pragma unroll 1
    for (int i = 0; i < bits.n; i += 2) {
      v = gl_mul(v, (idx >> i) & 1 ? bits.t[i] : 1);
      odd = gl_mul(odd, (idx >> (i + 1)) & 1 ? bits.t[i + 1] : 1);
    }
    v = gl_mul(v, odd);
  }
  split(out, s.n, 0, e, v);
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

// a c, or with n_bits > 0 a c times the constants of table (n_bits of them,
// host memory, read before the launch returns) that bits off .. off + n_bits
// - 1 of an index select: has_a says whether desc's planes 0 and 1 are a
// (else a = 1); with n_bits > 0 the index's (lo, hi) planes follow.
// cudaErrorInvalidValue for n_bits < 0, off < 0, off + n_bits > 64, or
// neither a nor an index.
extern "C" int p2t_gl_mul_const(const long long* desc, int has_a,
                                unsigned long long c,
                                const unsigned long long* table, int off,
                                int n_bits, void* out, void* stream) {
  if (n_bits < 0 || off < 0 || off + n_bits > MAX_BITS || (!has_a && !n_bits))
    return (int)cudaErrorInvalidValue;
  const Strided<4> s = strided<4>(desc, (has_a ? 2 : 0) + (n_bits ? 2 : 0));
  BitTable bits;
  bits.off = off;
  bits.n = n_bits;
  for (int i = 0; i < MAX_BITS; ++i) bits.t[i] = i < n_bits ? table[i] : 1;
  const cudaStream_t st = (cudaStream_t)stream;
  long long* o = (long long*)out;
  if (!n_bits) {
    gl_mul_const_kernel<true, false><<<blocks(s.n), THREADS, 0, st>>>(
        s, c, bits, o);
  } else if (has_a) {
    gl_mul_const_kernel<true, true><<<blocks(s.n), THREADS, 0, st>>>(
        s, c, bits, o);
  } else {
    gl_mul_const_kernel<false, true><<<blocks(s.n), THREADS, 0, st>>>(
        s, c, bits, o);
  }
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
