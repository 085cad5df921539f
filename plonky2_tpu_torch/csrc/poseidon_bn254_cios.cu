// Poseidon-BN254 permutation (width 4, x^5, 8 full + 56 partial rounds) for
// Hopper (sm_90a): the CIOS variant, a group of four threads per lane, on
// 29-bit limbs with 64-bit column sums.
//
// Replaces the Pallas TPU kernel plonky2_tpu/kernels/poseidon_bn254_pallas.py
// (permute / permute_lanes -> _kernel, with _multi_cios, _exp5_ark, _carry and
// _cond_sub), which ran the permutation on the TPU's vector units with 16-bit
// limbs in 32-bit columns, carries deferred, and fused multi-product
// Montgomery passes.  The port selects it with PLONKY2_TPU_PB_IMPL=cios;
// kernel A (poseidon_bn254.cu) is the default.  Canonical Montgomery state
// in, canonical state out, bit-exact with the torch plain version
// (hash/poseidon_bn254.permute_plain).
//
// What bounds it on the H100: 32-bit integer multiply-adds (IMAD, 64 a clock
// on each of the 132 SMs); a lane reads and writes 1 KB, which is negligible
// beside that.  The main path launches it at 7168 lanes (51 launches a step
// batch: leaf scans and FRI layers) and at 28672 (12: the Merkle levels of
// four oracles at once).  One thread a lane leaves 7168 lanes at 1.7 warps an
// SM, so there the time is one thread's chain of dependent operations; at
// 28672 lanes the card has the warps to hide latency, and the work counts.
//
// The design:
// - the TPU kernel's idea at the GPU's widths: a field element is 9 limbs
//   of 29 bits, and a product sums a_i b_j (< 2^58) into 17 64-bit columns,
//   each term one IMAD.WIDE (32 x 32 + 64 bits) with no carry between
//   columns; a Montgomery reduction by R' = 2^261 then runs limb by limb,
//   and one carry pass normalises the result.  Products of 32-bit words
//   (CIOS rows of 64-bit multiply-adds) cost 4 to 5 instructions a word
//   product, most of them carry handling, in one long dependent chain
//   (PERF.md, §6);
// - R' = 2^261 leaves so much room above p (p / R' < 0.006) that no value
//   needs a conditional subtraction until the end: a product of a and b is
//   below a b / R' + p.  The kernel's domain is x R' mod p: the input's
//   Montgomery form (R = 2^256) times 32, a shift; the constants arrive as
//   c 32 mod p (kernels/poseidon_bn254_cios.const_limbs); at the end one
//   product by 2^256 mod p divides by 32, and one subtraction of p makes the
//   value canonical;
// - two kernels, chosen at each launch by the lane count.  While one thread
//   a lane would give the card's SMs fewer than two warps each (below 8448
//   lanes on the H100), a group of G = 4 threads owns a lane (the group
//   kernel): more warps and a shorter chain a lane.  Above that, one thread
//   owns a lane (the lane kernel): the group repeats the partial rounds'
//   S-box on all four threads, so it issues about twice the products a
//   lane, which the larger launches pay for.  Measured on the H100 (PERF.md,
//   §6): at 7168 lanes the group kernel is faster, at 28672 the lane kernel;
// - the group kernel: thread e holds state element e; 32 lanes (128 threads) a
//   block, so 7168 lanes are 224 blocks, 6.8 warps an SM.  Full round: each
//   thread computes its own element's S-box, the group exchanges the four
//   results (__shfl_sync within the group) and thread i computes output i
//   of the linear layer as one pass, four products into the same columns
//   and one reduction.  Partial round: every thread computes y = s0^5 + c
//   itself (the threads of a warp issue together, so a lone thread would
//   cost the same), then thread j computes row_j s_j (s_0 = y) and, for
//   j > 0, s_j + y col_j; the four row terms are summed by two shuffle-xor
//   steps on the limbs and one carry pass, so every thread holds the new
//   s0.  Thread e reads and writes only its element's 16 limbs (128
//   contiguous bytes); lanes past n repeat lane n - 1 and store nothing, so
//   every group takes part in the shuffles;
// - the lane kernel: the same rounds on one thread, a linear-layer output and a
//   partial round's new s0 each one pass of four products; 128 lanes a
//   block.  Its S-box is a call (__noinline__): nvcc 12.9's front end
//   (cicc) crashed compiling the kernel with every S-box inlined;
// - x^2 and x^4 are squarings: 45 column products, the cross terms once by
//   2 a_i;
// - the 516 round constants (18.6 KB as limbs) are copied into shared memory
//   once a block; in the group kernel the four threads of a group read four
//   elements 9 words apart, four banks, no conflict.
//
// Exactness (tests/test_torch_cios_words.py models the limbs of both
// kernels and asserts each bound; p < 2^261 / 169):
// - every operand of a product has limbs below 2^29, so a_i b_j < 2^58; a
//   column takes at most 9 terms of a product and 9 of the reduction's m p,
//   below 18 * 2^58 + 2^36 < 2^63; a pass of four products and the
//   reduction, 45 terms, below 45 * 2^58 + 2^36 < 2^64; a squaring's
//   doubled terms (2 a_i) a_j < 2^59 take the place of two terms each;
// - a product's value (a b + m p) / 2^261 < a b / 2^261 + p with
//   m < 2^261; additive terms (a round constant, s_j) join the columns
//   before the carry pass;
// - the state stays below 58p < 2^260: the input times 32 plus ark0 is
//   below 33p; an S-box's output below 1.3p, plus c below 2.3p; a
//   linear-layer output below 1.08p; a partial round's row terms below
//   1.35p each, so s0 < 5.1p; s_j (j > 0) grows by y col_j < 1.02p a
//   partial round, from below 1.08p to below 58p; so the top limb of a
//   normalised value fits 29 bits;
// - the group kernel's four row terms' limb sums are below 2^31 before their
//   carry pass;
// - the output: the state (< 1.08p) times 2^256 mod p over 2^261 is below
//   1.01p, and one subtraction of p makes it canonical.
//
// What still holds it back (PERF.md, §6): each partial round's S-box is
// three dependent products, and 56 of the 64 rounds are partial.  At 7168
// lanes a group's chain sets the time, most of it the reductions' limb by
// limb steps and the carry passes, which are serial; at 28672 lanes the
// lane kernel holds 254 registers, so an SM runs 8 warps.
//
// ptxas -v (sm_90a, nvcc 12.9, printed by chip_smoke.py on the H100): the
// group kernel 80 registers, no spills; the lane kernel 254 registers, an
// 8-byte stack frame, 8 bytes of spill stores and loads; each 18,576 bytes
// of static shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef uint32_t u32;
typedef unsigned long long u64;

constexpr int WIDTH = 4;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 56;

// Offsets (in field elements) into the constant buffer, in the order the
// wrapper (kernels/poseidon_bn254.const_elements) lays them out.
constexpr int OFF_ARK0 = 0;                              // [4]
constexpr int OFF_ARK_FIRST = OFF_ARK0 + WIDTH;          // [4][4]
constexpr int OFF_ARK_SECOND = OFF_ARK_FIRST + 16;       // [4][4]
constexpr int OFF_M = OFF_ARK_SECOND + 16;               // [4 j][4 i]
constexpr int OFF_P = OFF_M + 16;                        // [4 j][4 i]
constexpr int OFF_PART_C = OFF_P + 16;                   // [56]
constexpr int OFF_S_ROW = OFF_PART_C + PARTIAL;          // [56][4]
constexpr int OFF_S_COL = OFF_S_ROW + PARTIAL * 4;       // [56][3]
constexpr int N_CONST = OFF_S_COL + PARTIAL * 3;

constexpr int NL = 9;                  // limbs an element
constexpr int LB = 29;                 // bits a limb
constexpr u32 LM = (1u << LB) - 1;
constexpr u32 kN0 = 0x0fffffffu;       // -p^-1 mod 2^29
constexpr int IN_WORDS = 8;            // 32-bit words of an input element

constexpr int G = WIDTH;               // group kernel: threads a lane
constexpr int LANES = 32;              // group kernel: lanes a block
constexpr int THREADS = G * LANES;
constexpr unsigned ALL = 0xffffffffu;  // every thread of a warp shuffles
constexpr int LANE_THREADS = 128;      // lane kernel: lanes a block
constexpr int GROUP_BELOW = 2 * 32;    // the group kernel below this many lanes an SM

struct Fl {
  u32 l[NL];
};

// 64-bit column sums: column k has weight 2^(29 k).
struct Cols {
  u64 c[2 * NL];
};

// p and 2^256 mod p in 29-bit limbs.
__device__ __forceinline__ Fl fl_p() {
  return Fl{{0x10000001u, 0x1f0fac9fu, 0x0e5c2450u, 0x07d090f3u, 0x1585d283u,
             0x02db40c0u, 0x00a6e141u, 0x0e5c2634u, 0x0030644eu}};
}
__device__ __forceinline__ Fl fl_r_mod_p() {
  return Fl{{0x0ffffffbu, 0x04b1a0e2u, 0x18334a6bu, 0x18ed2b3eu, 0x1462e36fu,
             0x11b7bc3cu, 0x1cbd99bau, 0x183340fbu, 0x000e0a77u}};
}
__device__ __forceinline__ Fl fl_zero() {
  return Fl{{0, 0, 0, 0, 0, 0, 0, 0, 0}};
}

__device__ __forceinline__ Fl load_const(const u32* c, int idx) {
  Fl r;
#pragma unroll
  for (int k = 0; k < NL; ++k) r.l[k] = c[idx * NL + k];
  return r;
}

__device__ __forceinline__ void zero(Cols& t) {
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) t.c[k] = 0;
}

// t += a b.
__device__ __forceinline__ void mul_add(Cols& t, const Fl& a, const Fl& b) {
#pragma unroll
  for (int i = 0; i < NL; ++i)
#pragma unroll
    for (int j = 0; j < NL; ++j) t.c[i + j] += (u64)a.l[i] * b.l[j];
}

// t += a^2: the cross terms once, by 2 a_i (< 2^30).
__device__ __forceinline__ void sqr_add(Cols& t, const Fl& a) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    t.c[2 * i] += (u64)a.l[i] * a.l[i];
    const u32 d = a.l[i] << 1;
#pragma unroll
    for (int j = i + 1; j < NL; ++j) t.c[i + j] += (u64)d * a.l[j];
  }
}

// (t + m p) / 2^261 + add, normalised, for the m < 2^261 that clears the low
// 261 bits: one reduction step a limb, then one carry pass.
__device__ __forceinline__ Fl redc(Cols& t, const Fl& add) {
  const Fl p = fl_p();
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const u32 m = ((u32)t.c[i] * kN0) & LM;
#pragma unroll
    for (int j = 0; j < NL; ++j) t.c[i + j] += (u64)m * p.l[j];
    t.c[i + 1] += t.c[i] >> LB;  // t.c[i] is a multiple of 2^29 now
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) t.c[NL + k] += add.l[k];
  Fl r;
#pragma unroll
  for (int k = NL; k < 2 * NL - 1; ++k) {
    t.c[k + 1] += t.c[k] >> LB;
    r.l[k - NL] = (u32)t.c[k] & LM;
  }
  r.l[NL - 1] = (u32)t.c[2 * NL - 1];
  return r;
}

// a b / 2^261 + k p + add.
__device__ __forceinline__ Fl mont(const Fl& a, const Fl& b, const Fl& add) {
  Cols t;
  zero(t);
  mul_add(t, a, b);
  return redc(t, add);
}

__device__ __forceinline__ Fl msqr(const Fl& a) {
  Cols t;
  zero(t);
  sqr_add(t, a);
  return redc(t, fl_zero());
}

// x^5 + c.
__device__ __forceinline__ Fl exp5_add(const Fl& x, const Fl& c) {
  return mont(msqr(msqr(x)), x, c);
}

// The same as a call, for the lane kernel (see the header).
__device__ __noinline__ Fl exp5_add_call(Fl x, Fl c) { return exp5_add(x, c); }

// Element x of thread src of this thread's group.
__device__ __forceinline__ Fl shfl(const Fl& x, int src) {
  Fl r;
#pragma unroll
  for (int k = 0; k < NL; ++k) r.l[k] = __shfl_sync(ALL, x.l[k], src, G);
  return r;
}

// x plus the x of the group's thread whose index differs by mask, limb by
// limb.
__device__ __forceinline__ Fl add_xor(const Fl& x, int mask) {
  Fl r;
#pragma unroll
  for (int k = 0; k < NL; ++k)
    r.l[k] = x.l[k] + __shfl_xor_sync(ALL, x.l[k], mask, G);
  return r;
}

// Limbs below 2^32 -> limbs below 2^29, the value unchanged (below 2^261).
__device__ __forceinline__ Fl carry(const Fl& x) {
  Fl r;
  u32 c = 0;
#pragma unroll
  for (int k = 0; k < NL - 1; ++k) {
    const u64 v = (u64)x.l[k] + c;
    r.l[k] = (u32)v & LM;
    c = (u32)(v >> LB);
  }
  r.l[NL - 1] = x.l[NL - 1] + c;
  return r;
}

__device__ __forceinline__ Fl select(bool c, const Fl& a, const Fl& b) {
  Fl r;
#pragma unroll
  for (int k = 0; k < NL; ++k) r.l[k] = c ? a.l[k] : b.l[k];
  return r;
}

// An input element (x 2^256 mod p as 16-bit limbs in int64) plus the
// constant a, in the kernel's domain: x 2^261 (< 32p) + a, below 33p.
// Limb i of x 2^261 is bits 29 i - 5 .. 29 i + 23 of the input.
__device__ __forceinline__ Fl load_element(const long long* src, const Fl& a) {
  u32 w[IN_WORDS + 1];
#pragma unroll
  for (int k = 0; k < IN_WORDS; ++k)
    w[k] = (u32)src[2 * k] | ((u32)src[2 * k + 1] << 16);
  w[IN_WORDS] = 0;
  Fl x;
  x.l[0] = (w[0] << 5) & LM;
#pragma unroll
  for (int i = 1; i < NL; ++i) {
    const int q = LB * i - 5;
    const u64 v = (u64)w[q / 32] | ((u64)w[q / 32 + 1] << 32);
    x.l[i] = (u32)(v >> (q % 32)) & LM;
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) x.l[k] += a.l[k];
  return carry(x);
}

// x 2^261 (below 58p) -> canonical x 2^256 mod p as 16-bit limbs: one
// product by 2^256 mod p (below 1.01p), then at most one subtraction of p.
__device__ __forceinline__ void store_element(long long* dst, const Fl& s) {
  Fl c = mont(s, fl_r_mod_p(), fl_zero());
  const Fl p = fl_p();
  Fl d;
  u32 borrow = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const u32 v = c.l[k] - p.l[k] - borrow;
    borrow = v >> 31;  // limbs < 2^29: a borrow sets the top bit
    d.l[k] = v & LM;
  }
  if (!borrow) c = d;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int q = 16 * k, i = q / LB;
    const u64 v = (u64)c.l[i] | (i + 1 < NL ? (u64)c.l[i + 1] << LB : 0);
    dst[k] = (long long)((v >> (q % LB)) & 0xFFFFu);
  }
}

// Group kernel: the full round for this thread's element e, the S-box plus
// its constant, then output e of the linear layer sum_j M[j][e] y_j (M at
// off, [j][i]).
__device__ __forceinline__ Fl full_round(const Fl& s, const u32* c, int ark,
                                         int off, int e) {
  const Fl y = exp5_add(s, load_const(c, ark));
  Cols t;
  zero(t);
#pragma unroll
  for (int j = 0; j < WIDTH; ++j)
    mul_add(t, load_const(c, off + j * WIDTH + e), shfl(y, j));
  return redc(t, fl_zero());
}

__global__ void __launch_bounds__(THREADS)
poseidon_bn254_cios_kernel_group(const long long* __restrict__ in,
                                 long long* __restrict__ out,
                                 const u32* __restrict__ consts, int n) {
  __shared__ __align__(16) u32 kC[N_CONST * NL];
  for (int q = threadIdx.x; q < N_CONST * NL / 4; q += THREADS)
    reinterpret_cast<uint4*>(kC)[q] = __ldg(reinterpret_cast<const uint4*>(consts) + q);
  __syncthreads();

  const int e = threadIdx.x % G;
  const int want = blockIdx.x * LANES + threadIdx.x / G;
  const int lane = min(want, n - 1);
  Fl s = load_element(in + ((size_t)lane * WIDTH + e) * 16,
                      load_const(kC, OFF_ARK0 + e));

#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r)
    s = full_round(s, kC, OFF_ARK_FIRST + r * WIDTH + e,
                   r == HALF_FULL - 1 ? OFF_P : OFF_M, e);

  Fl s0 = shfl(s, 0);
  const int col = OFF_S_COL + (e == 0 ? 0 : e - 1);  // thread 0's is unused
#pragma unroll 1
  for (int r = 0; r < PARTIAL; ++r) {
    const Fl y = exp5_add(s0, load_const(kC, OFF_PART_C + r));
    const Fl row = mont(select(e == 0, y, s),
                        load_const(kC, OFF_S_ROW + r * WIDTH + e), fl_zero());
    s = mont(y, load_const(kC, col + r * (WIDTH - 1)), s);
    s0 = carry(add_xor(add_xor(row, 1), 2));
  }
  s = select(e == 0, s0, s);

#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r)
    s = full_round(s, kC, OFF_ARK_SECOND + r * WIDTH + e, OFF_M, e);

  if (want < n) store_element(out + ((size_t)lane * WIDTH + e) * 16, s);
}

// Lane kernel: out_i = sum_j M[j][i] y_j (M at off, [j][i]), each output one
// pass.
__device__ __forceinline__ void mix(Fl (&s)[WIDTH], const u32* c, int off) {
  Fl out[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    Cols t;
    zero(t);
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) mul_add(t, load_const(c, off + j * WIDTH + i), s[j]);
    out[i] = redc(t, fl_zero());
  }
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = out[i];
}

__global__ void __launch_bounds__(LANE_THREADS)
poseidon_bn254_cios_kernel_lane(const long long* __restrict__ in,
                                long long* __restrict__ out,
                                const u32* __restrict__ consts, int n) {
  __shared__ __align__(16) u32 kC[N_CONST * NL];
  for (int q = threadIdx.x; q < N_CONST * NL / 4; q += LANE_THREADS)
    reinterpret_cast<uint4*>(kC)[q] = __ldg(reinterpret_cast<const uint4*>(consts) + q);
  __syncthreads();

  const int lane = blockIdx.x * LANE_THREADS + threadIdx.x;
  if (lane >= n) return;
  Fl s[WIDTH];
#pragma unroll
  for (int e = 0; e < WIDTH; ++e)
    s[e] = load_element(in + ((size_t)lane * WIDTH + e) * 16,
                        load_const(kC, OFF_ARK0 + e));

#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r) {
#pragma unroll
    for (int e = 0; e < WIDTH; ++e)
      s[e] = exp5_add_call(s[e], load_const(kC, OFF_ARK_FIRST + r * WIDTH + e));
    mix(s, kC, r == HALF_FULL - 1 ? OFF_P : OFF_M);
  }

#pragma unroll 1
  for (int r = 0; r < PARTIAL; ++r) {
    s[0] = exp5_add_call(s[0], load_const(kC, OFF_PART_C + r));
    Cols t;
    zero(t);
#pragma unroll
    for (int j = 0; j < WIDTH; ++j)
      mul_add(t, load_const(kC, OFF_S_ROW + r * WIDTH + j), s[j]);
#pragma unroll
    for (int k = 1; k < WIDTH; ++k)
      s[k] = mont(s[0], load_const(kC, OFF_S_COL + r * (WIDTH - 1) + k - 1), s[k]);
    s[0] = redc(t, fl_zero());
  }

#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r) {
#pragma unroll
    for (int e = 0; e < WIDTH; ++e)
      s[e] = exp5_add_call(s[e], load_const(kC, OFF_ARK_SECOND + r * WIDTH + e));
    mix(s, kC, OFF_M);
  }

#pragma unroll
  for (int e = 0; e < WIDTH; ++e)
    store_element(out + ((size_t)lane * WIDTH + e) * 16, s[e]);
}

}  // namespace

extern "C" int p2t_poseidon_bn254_cios_n_const() { return N_CONST; }

// in, out: (n, 4, 16) int64 Montgomery limbs, contiguous, on the device.
// consts: N_CONST x 9 u32, each element c of kernels/poseidon_bn254
// .const_elements as the 29-bit limbs of c 32 mod p, on the device, 16-byte
// aligned.  Returns the first CUDA error, else 0.
extern "C" int p2t_poseidon_bn254_cios_permute(const void* in, void* out,
                                               const void* consts, int n,
                                               void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if ((long long)n < (long long)GROUP_BELOW * sms)
    poseidon_bn254_cios_kernel_group<<<(n + LANES - 1) / LANES, THREADS, 0, st>>>(
        (const long long*)in, (long long*)out, (const u32*)consts, n);
  else
    poseidon_bn254_cios_kernel_lane<<<(n + LANE_THREADS - 1) / LANE_THREADS,
                                      LANE_THREADS, 0, st>>>(
        (const long long*)in, (long long*)out, (const u32*)consts, n);
  return (int)cudaGetLastError();
}
