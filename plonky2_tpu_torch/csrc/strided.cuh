// Operands read where they lie, for the Goldilocks and QE kernels
// (goldilocks_mul.cu, goldilocks_ext.cu).
//
// A kernel's input planes are walked over one broadcast lead shape by their
// element strides, 0 along an axis a plane broadcasts.  The wrapper
// (kernels/goldilocks_mul.py descriptor) passes them as a host array of
// int64 words: n, ndim, dims[MAX_DIMS] (size-1 axes dropped, axes that every
// plane walks contiguously merged), then per plane its pointer and its
// strides; the C entry copies the words into the kernel's by-value argument,
// so nothing on the device is read for them and a launch can be captured in
// a CUDA graph.

#pragma once

namespace {

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

// The descriptor's first `planes` planes; planes past them repeat plane 0.
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

// The offsets of element e < n in each plane.  The outermost coordinate is
// what is left of e once the inner ones are divided out, so a lead shape of
// one dimension takes no division.
template <int NP>
__device__ __forceinline__ void offsets(const Strided<NP>& s, long long e,
                                        long long* off) {
  long long coord[MAX_DIMS];
#pragma unroll
  for (int d = MAX_DIMS - 1; d >= 0; --d) {
    if (d == 0) {
      coord[d] = e;
    } else if (d < s.ndim) {
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

}  // namespace
