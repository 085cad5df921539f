"""The PLONK stage's field arithmetic on the card: wrappers of the CUDA
kernels in ``csrc/goldilocks_mul.cu``.

- ``gl_mul(a, b)`` and ``gl_mul_const(a, c)``: Goldilocks products (JAX:
  ``plonky2_tpu/fields/goldilocks.py`` ``mul`` and ``mul_const``), behind
  ``fields/goldilocks.mul`` and ``mul_const``;
- ``qe_mul(a, b[, c])``: the quadratic-extension product a b, or a b + c
  (JAX: ``plonky2_tpu/fields/goldilocks_ext.py`` ``mul`` and ``mul_add``),
  behind ``fields/goldilocks_ext.mul`` and ``mul_add``;
- ``coset_interp_scan``: the interpolation gate's chunk steps (JAX: the
  ``jax.lax.scan`` of ``plonky2_tpu/gates/gates.py``
  CosetInterpolationGate.eval), behind ``gates/gates.coset_interp_scan``.

Under ``jit`` the JAX package runs each product as one fused loop on its
device; the port's plain versions issue some 146 int64 torch ops a product.

The operands broadcast against each other in every direction at the call
sites ((B, 1) against (B, n), an (n,) constant table against (B, n), views
made by slicing), and the planes of one operand may differ in shape and
strides.  ``broadcast_layout`` turns the planes' shapes and strides into
one lead shape and each plane's element strides over it (0 along a
broadcast axis), with size-1 axes dropped and axes that every plane walks
contiguously merged, so that the kernel reads every operand where it lies:
no copy is made.  Each output is one ``torch.empty`` of 2 or 4 planes
(16 for the scan), returned as views.  Nothing is made from host data and
nothing waits for the device, so the launches can be captured in the
compiled verifier's CUDA graph.  An empty lead shape launches nothing.

The wrappers take CUDA tensors only and raise ``build.KernelError`` for any
other device; the field modules dispatch to the plain versions for CPU
tensors.  ``gl_mul.launches``, ``gl_mul_const.launches``,
``qe_mul.launches`` and ``coset_interp_scan.launches`` count launches.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..fields.goldilocks import P
from . import build

MAX_DIMS = 4  # csrc/goldilocks_mul.cu MAX_DIMS


def broadcast_layout(shapes, strides):
    """The planes' shapes and element strides -> (lead shape, dims, one
    stride tuple a plane over dims).

    ``lead`` is the broadcast of ``shapes``; ``dims`` is ``lead`` with its
    size-1 axes dropped and each run of axes that every plane walks as one
    (stride[d] = stride[d + 1] x dims[d + 1]) merged, so that an element's
    row-major index over ``dims`` is its index in a contiguous output of
    shape ``lead``.  A plane's stride is 0 along an axis it broadcasts."""
    lead = tuple(int(n) for n in np.broadcast_shapes(*shapes))
    keep = [d for d, n in enumerate(lead) if n != 1]
    aligned = []
    for shape, stride in zip(shapes, strides):
        off = len(lead) - len(shape)
        aligned.append([0 if d < off or shape[d - off] == 1
                        else stride[d - off] for d in keep])
    dims, merged = [], [[] for _ in aligned]
    for i, d in enumerate(keep):
        n = lead[d]
        if dims and all(m[-1] == st[i] * n for m, st in zip(merged, aligned)):
            dims[-1] *= n
            for m, st in zip(merged, aligned):
                m[-1] = st[i]
        else:
            dims.append(n)
            for m, st in zip(merged, aligned):
                m.append(st[i])
    return lead, tuple(dims), [tuple(m) for m in merged]


def _check(planes, what):
    device = planes[0].device
    if device.type != "cuda":
        raise build.KernelError(f"no {what} kernel for {device}")
    for t in planes:
        if t.dtype != torch.int64 or t.device != device:
            raise ValueError(f"{what}: every plane must be int64 on "
                             f"{device}, got {t.dtype} on {t.device}")
    return device


def _descriptor(planes, what):
    """(lead shape, element count, the host words of csrc/goldilocks_mul.cu's
    descriptor: n, ndim, dims, then each plane's pointer and strides)."""
    lead, dims, strides = broadcast_layout([t.shape for t in planes],
                                           [t.stride() for t in planes])
    if len(dims) > MAX_DIMS:
        raise ValueError(f"{what}: {len(dims)} dimensions after merging "
                         f"(shapes {[tuple(t.shape) for t in planes]}), the "
                         f"kernel takes {MAX_DIMS}")
    pad = MAX_DIMS - len(dims)
    n = math.prod(lead)
    words = [n, len(dims), *dims, *([1] * pad)]
    for t, st in zip(planes, strides):
        words += [t.data_ptr(), *st, *([0] * pad)]
    return lead, n, (ctypes.c_longlong * len(words))(*words)


def _launch(entry, planes, n_out, what, *args):
    """Launch ``entry`` over the broadcast of ``planes``; returns its
    ``n_out`` output planes (views of one allocation) and whether it
    launched (not for an empty lead shape)."""
    device = _check(planes, what)
    lead, n, desc = _descriptor(planes, what)
    out = torch.empty((n_out,) + lead, dtype=torch.int64, device=device)
    if n:
        with torch.cuda.device(device):  # the launch goes to the current device
            rc = getattr(build.library(), entry)(
                desc, *args, out.data_ptr(), build.stream_handle(device))
        build.check(rc, f"{what} launch")
    return tuple(out.unbind(0)), n > 0


def gl_mul(a, b):
    """a b for GL values a, b of broadcastable shapes."""
    out, launched = _launch("p2t_gl_mul", [a[0], a[1], b[0], b[1]], 2,
                            "Goldilocks product")
    gl_mul.launches += launched
    return out


def gl_mul_const(a, c):
    """a c for a GL value a and a python-int constant c (by value)."""
    out, launched = _launch("p2t_gl_mul_const", [a[0], a[1]], 2,
                            "Goldilocks product by a constant",
                            ctypes.c_uint64(int(c) % P))
    gl_mul_const.launches += launched
    return out


def _qe_planes(a):
    return [a[0][0], a[0][1], a[1][0], a[1][1]]


def qe_mul(a, b, c=None):
    """a b, or a b + c, for QE values of broadcastable shapes."""
    planes = _qe_planes(a) + _qe_planes(b)
    if c is not None:
        planes += _qe_planes(c)
    out, launched = _launch("p2t_qe_mul", planes, 4, "QE product",
                            int(c is not None))
    qe_mul.launches += launched
    return ((out[0], out[1]), (out[2], out[3]))


def _ea_planes(x):
    return _qe_planes(x[0]) + _qe_planes(x[1])


def _ea(planes):
    return (((planes[0], planes[1]), (planes[2], planes[3])),
            ((planes[4], planes[5]), (planes[6], planes[7])))


def _frame_strides(t, frame, axes):
    """t's element strides over the scan's (lane, step, chunk) frame: t's
    axes are ``axes`` of the frame, in order; 0 along any other axis or
    where t broadcasts."""
    out = [0, 0, 0]
    for size, stride, ax in zip(t.shape, t.stride(), axes):
        if size != 1:
            if size != frame[ax]:
                raise ValueError(f"interpolation scan: shape {tuple(t.shape)}"
                                 f" against the frame {frame}")
            out[ax] = stride
    return out


def coset_interp_scan(ev, pr, val, pt, xs, ws, active):
    """The interpolation gate's chunk steps (gates/gates.py
    ``coset_interp_scan_plain``): ev, pr EA (B, C); val EA (B, deg, C); pt
    EA broadcastable to (B, C); xs, ws GL (deg, C); active bool (deg, C) ->
    (ev, pr) EA (B, C)."""
    state = _ea_planes(ev) + _ea_planes(pr)
    planes = state + _ea_planes(val) + _ea_planes(pt) + list(xs) + list(ws)
    device = _check(planes, "interpolation scan")
    if active.dtype != torch.bool or active.device != device:
        raise ValueError(f"interpolation scan: active must be bool on "
                         f"{device}, got {active.dtype} on {active.device}")
    lanes, chunks = np.broadcast_shapes(*(t.shape for t in state))
    deg = xs[0].shape[0]
    frame = (lanes, deg, chunks)
    words = [lanes, deg, chunks]
    layout = ([(t, (0, 2)) for t in state]
              + [(t, (0, 1, 2)) for t in _ea_planes(val)]
              + [(t, (0, 2)) for t in _ea_planes(pt)]
              + [(t, (1, 2)) for t in list(xs) + list(ws) + [active]])
    for t, axes in layout:
        if t.dim() != len(axes):
            raise ValueError(f"interpolation scan: shape {tuple(t.shape)} "
                             f"has not {len(axes)} axes")
        words += [t.data_ptr(), *_frame_strides(t, frame, axes)]
    out = torch.empty((16, lanes, chunks), dtype=torch.int64, device=device)
    if lanes * chunks:
        desc = (ctypes.c_longlong * len(words))(*words)
        with torch.cuda.device(device):
            rc = build.library().p2t_coset_interp_scan(
                desc, out.data_ptr(), build.stream_handle(device))
        build.check(rc, "interpolation scan launch")
        coset_interp_scan.launches += 1
    planes = out.unbind(0)
    return _ea(planes[:8]), _ea(planes[8:])


gl_mul.launches = 0
gl_mul_const.launches = 0
qe_mul.launches = 0
coset_interp_scan.launches = 0
