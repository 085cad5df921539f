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
//   (QE[Y]/(Y^2 - 7), ea_mul in goldilocks.cuh); chunk 0 starts at (0, 1),
//   chunk c >= 1 at the gate's intermediate wires, and val_j is read from
//   the gate's value columns through the schedule (:277-280's gather).
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
// chain of them in one launch; one thread an element, 128-thread blocks.
// The scan's steps, deg dependent steps of three EA products in the JAX
// form, would give one thread a lane and chunk, 768 threads at B = 256 on
// 6 SMs; they run side by side instead, a group of threads a step, through
// prefix and suffix products (below), with the gate's schedule by value.

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
//
// The scan's recurrence, ev' = ev t_j + u_j pr, pr' = pr t_j with t_j = pt -
// x_j and u_j = w_j v_j, unrolls over a chunk's steps (the EA ring is
// commutative) to
//   pr_out = pr0 P,  ev_out = ev0 P + pr0 sum_j u_j prod_(i != j) t_i,
// P = prod_j t_j; an inactive step is t = 1, u = 0.  A chunk of a lane is a
// segment of S = 2^LOG_S >= deg steps of G threads each, inside one warp
// (G = 4 up to S = 8, then 2 and 1): the group of step j forms t_j and u_j;
// the segment's exclusive prefix and suffix products of the t's come from
// LOG_S rounds of __shfl_up_sync / __shfl_down_sync each (the two chains
// side by side); step j's term is u_j times both; the terms are summed by
// xor-shuffles; and the group of step 0, which holds P as its inclusive
// suffix product, writes the chunk.  Every EA product is split over the G
// threads of a group, a QE product each at G = 4 (ea_mul_group), so that a
// thread makes 7 Goldilocks products an EA product, not 22, and 4 times as
// many warps share the work.  Steps past deg, inactive steps and segments
// past the end take t = 1 and u = 0; every thread of the warp stays to the
// shuffles (the full mask).

constexpr int SCAN_BLOCK = 64;       // two warps: segments never straddle one
constexpr int SCAN_MAX_LOG_SEG = 5;  // a segment lies inside one warp
constexpr int SCAN_MAX_CELLS = 128;  // chunks x S steps in the schedule
constexpr unsigned FULL = 0xFFFFFFFFu;

// Planes, each with strides over (lane, column): inter_eval (8) and
// inter_prod (8), column c - 1 for chunk c >= 1 (chunk 0 starts at ev = 0,
// pr = 1); pt (8), column c (stride 0 where it broadcasts); the values (8),
// column col[cell].
constexpr int SCAN_PLANES = 32;
enum { EV = 0, PR = 8, PT = 16, VAL = 24 };

// The gate's schedule and the operands, by value (__grid_constant__: read
// through the parameter bank, no copy).  Cell c S + j is step j of chunk c:
// its domain point x, its barycentric weight w and the value column col, -1
// where the step is inactive or j >= deg.
struct Scan {
  u64 x[SCAN_MAX_CELLS];
  u64 w[SCAN_MAX_CELLS];
  int col[SCAN_MAX_CELLS];
  const long long* ptr[SCAN_PLANES];
  long long stride[SCAN_PLANES][2];
  int lanes, chunks;
};

__device__ __forceinline__ u64 scan_gl(const Scan& s, int k, long long b,
                                       long long col) {
  return join(s.ptr[k], s.ptr[k + 1], s.stride[k][0] * b + s.stride[k][1] * col,
              s.stride[k + 1][0] * b + s.stride[k + 1][1] * col);
}

__device__ __forceinline__ Ea scan_ea(const Scan& s, int k, long long b,
                                      long long col) {
  return Ea{Qe{scan_gl(s, k, b, col), scan_gl(s, k + 2, b, col)},
            Qe{scan_gl(s, k + 4, b, col), scan_gl(s, k + 6, b, col)}};
}

// f applied to each of an EA value's four words.
template <class F>
__device__ __forceinline__ Ea ea_map(const Ea& v, F f) {
  return Ea{Qe{f(v.a.c0), f(v.a.c1)}, Qe{f(v.b.c0), f(v.b.c1)}};
}

__device__ __forceinline__ Ea ea_select(bool c, const Ea& x, const Ea& y) {
  return Ea{Qe{c ? x.a.c0 : y.a.c0, c ? x.a.c1 : y.a.c1},
            Qe{c ? x.b.c0 : y.b.c0, c ? x.b.c1 : y.b.c1}};
}

__device__ __forceinline__ Qe qe_xor(const Qe& v, int m) {
  return Qe{__shfl_xor_sync(FULL, v.c0, m), __shfl_xor_sync(FULL, v.c1, m)};
}

__device__ __forceinline__ Qe qe_times_w(const Qe& v) {
  return Qe{gl_mul(v.c0, W), gl_mul(v.c1, W)};
}

// x y, (x.a y.a + W x.b y.b) + (x.a y.b + x.b y.a) Y, by the G threads of a
// group (g its thread), each holding all of x and y: at G = 4 thread g makes
// x.a y.a, x.b y.b, x.a y.b or x.b y.a, at G = 2 one half of the product;
// the halves are exchanged by __shfl_xor_sync and every thread returns the
// whole product.
template <int G>
__device__ __forceinline__ Ea ea_mul_group(const Ea& x, const Ea& y, int g) {
  if constexpr (G == 1) {
    return ea_mul(x, y);
  } else if constexpr (G == 2) {
    const Qe p = qe_mul(x.a, g ? y.b : y.a);
    const Qe q = qe_mul(x.b, g ? y.a : y.b);
    const Qe half = qe_add(p, g ? q : qe_times_w(q));
    const Qe other = qe_xor(half, 1);
    return g ? Ea{other, half} : Ea{half, other};
  } else {
    const Qe p = qe_mul(g & 1 ? x.b : x.a, (g ^ (g >> 1)) & 1 ? y.b : y.a);
    const Qe q = qe_xor(p, 1);
    const Qe even = g & 1 ? q : p;  // x.a y.a (g < 2) or x.a y.b
    const Qe odd = g & 1 ? p : q;   // x.b y.b (g < 2) or x.b y.a
    const Qe half = qe_add(even, g < 2 ? qe_times_w(odd) : odd);
    const Qe other = qe_xor(half, 2);
    return g < 2 ? Ea{half, other} : Ea{other, half};
  }
}

// Coordinate k (a.c0, a.c1, b.c0, b.c1) of v into planes plane + 2 k and
// plane + 2 k + 1 of out.
__device__ __forceinline__ void scan_store(long long* out, long long n,
                                           int plane, long long e, const Ea& v,
                                           int k) {
  split(out, n, plane + 2 * k, e,
        k == 0 ? v.a.c0 : k == 1 ? v.a.c1 : k == 2 ? v.b.c0 : v.b.c1);
}

// out (16, lanes, chunks): ev's eight planes, then pr's.
template <int LOG_S>
__global__ void __launch_bounds__(SCAN_BLOCK)
coset_interp_scan_kernel(const __grid_constant__ Scan s, long long* out) {
  constexpr int LOG_G = LOG_S <= 3 ? 2 : SCAN_MAX_LOG_SEG - LOG_S;
  constexpr int S = 1 << LOG_S, G = 1 << LOG_G, WIDTH = S * G;
  const long long t = (long long)blockIdx.x * SCAN_BLOCK + threadIdx.x;
  const long long seg = t >> (LOG_S + LOG_G);
  const int j = (int)(t >> LOG_G) & (S - 1);
  const int g = (int)t & (G - 1);
  const long long n = (long long)s.lanes * s.chunks;
  const bool live = seg < n;
  const long long b = live ? seg / s.chunks : 0;
  const int c = live ? (int)(seg % s.chunks) : 0;
  const int cell = c * S + j;
  const int col = live ? s.col[cell] : -1;
  const Ea zero{Qe{0, 0}, Qe{0, 0}};
  const Ea one{Qe{1, 0}, Qe{0, 0}};

  // every load first: the step's value and the point; the chunk's start on
  // the group that writes it
  Ea v = zero, pt = zero, ev0 = zero, pr0 = one;
  if (col >= 0) v = scan_ea(s, VAL, b, col);
  if (live) pt = scan_ea(s, PT, b, c);
  if (live && j == 0 && c > 0) {
    ev0 = scan_ea(s, EV, b, c - 1);
    pr0 = scan_ea(s, PR, b, c - 1);
  }
  const u64 x = s.x[cell];
  const u64 w = s.w[cell];

  // t_j = pt - x_j in the base coordinate of the first QE, u_j = w_j v_j
  Ea tj = pt;
  tj.a.c0 = gl_sub(pt.a.c0, x);
  tj = ea_select(col >= 0, tj, one);
  const Ea u = ea_map(v, [w](u64 e) { return gl_mul(e, w); });

  // inclusive prefix and suffix products of the segment's t's
  Ea pre = tj, suf = tj;
#pragma unroll
  for (int d = 1; d < S; d <<= 1) {
    const Ea lo = ea_map(pre, [d](u64 e) {
      return __shfl_up_sync(FULL, e, d * G, WIDTH); });
    const Ea hi = ea_map(suf, [d](u64 e) {
      return __shfl_down_sync(FULL, e, d * G, WIDTH); });
    pre = ea_mul_group<G>(ea_select(j >= d, lo, one), pre, g);
    suf = ea_mul_group<G>(suf, ea_select(j + d < S, hi, one), g);
  }
  // exclusive: the products of the t's before and after step j
  const Ea before = ea_select(j > 0, ea_map(pre, [](u64 e) {
    return __shfl_up_sync(FULL, e, G, WIDTH); }), one);
  const Ea after = ea_select(j < S - 1, ea_map(suf, [](u64 e) {
    return __shfl_down_sync(FULL, e, G, WIDTH); }), one);
  Ea sum = ea_mul_group<G>(ea_mul_group<G>(u, before, g), after, g);
#pragma unroll
  for (int d = 1; d < S; d <<= 1)
    sum = ea_add(sum, ea_map(sum, [d](u64 e) {
      return __shfl_xor_sync(FULL, e, d * G, WIDTH); }));

  // on the group of step 0, suf = P, the product of every t of the chunk;
  // every thread computes, for the shuffles' full mask
  const Ea ev = ea_add(ea_mul_group<G>(ev0, suf, g),
                       ea_mul_group<G>(pr0, sum, g));
  const Ea pr = ea_mul_group<G>(pr0, suf, g);
  if (live && j == 0) {
    for (int k = g; k < 4; k += G) {  // the group shares the stores
      scan_store(out, n, 0, seg, ev, k);
      scan_store(out, n, 8, seg, pr, k);
    }
  }
}

template <int LOG_S>
void launch_scan(const Scan& s, cudaStream_t stream, long long* out) {
  constexpr int LOG_G = LOG_S <= 3 ? 2 : SCAN_MAX_LOG_SEG - LOG_S;
  const long long threads = ((long long)s.lanes * s.chunks) << (LOG_S + LOG_G);
  const unsigned grid = (unsigned)((threads + SCAN_BLOCK - 1) / SCAN_BLOCK);
  coset_interp_scan_kernel<LOG_S><<<grid, SCAN_BLOCK, 0, stream>>>(s, out);
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

// desc: per plane (SCAN_PLANES, in the order of the enum above) its pointer
// and its strides over (lane, column); xs, ws, cols: the schedule's
// chunks x 2^log_seg cells (host memory, read before the launch returns),
// cols[cell] < 0 for a step that is inactive or past deg; out (16, lanes,
// chunks) int64, contiguous.  cudaErrorInvalidValue for lanes or chunks <
// 1, log_seg outside [0, 5] or more than SCAN_MAX_CELLS cells.
extern "C" int p2t_coset_interp_scan(const long long* desc,
                                     const unsigned long long* xs,
                                     const unsigned long long* ws,
                                     const int* cols, int lanes, int chunks,
                                     int log_seg, void* out, void* stream) {
  if (lanes < 1 || chunks < 1 || log_seg < 0 ||
      log_seg > SCAN_MAX_LOG_SEG || (chunks << log_seg) > SCAN_MAX_CELLS)
    return (int)cudaErrorInvalidValue;
  Scan s;
  s.lanes = lanes;
  s.chunks = chunks;
  const int cells = chunks << log_seg;
  for (int i = 0; i < SCAN_MAX_CELLS; ++i) {
    s.x[i] = i < cells ? xs[i] : 0;
    s.w[i] = i < cells ? ws[i] : 0;
    s.col[i] = i < cells ? cols[i] : -1;
  }
  for (int k = 0; k < SCAN_PLANES; ++k) {
    const long long* p = desc + 3 * k;
    s.ptr[k] = (const long long*)p[0];
    s.stride[k][0] = p[1];
    s.stride[k][1] = p[2];
  }
  const cudaStream_t st = (cudaStream_t)stream;
  long long* o = (long long*)out;
  switch (log_seg) {
    case 0: launch_scan<0>(s, st, o); break;
    case 1: launch_scan<1>(s, st, o); break;
    case 2: launch_scan<2>(s, st, o); break;
    case 3: launch_scan<3>(s, st, o); break;
    case 4: launch_scan<4>(s, st, o); break;
    default: launch_scan<5>(s, st, o); break;
  }
  return (int)cudaGetLastError();
}
