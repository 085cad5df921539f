"""The PLONK stage's field arithmetic on the card: wrappers of the CUDA
kernels in ``csrc/goldilocks_mul.cu``.

- ``gl_mul(a, b)`` and ``gl_mul_const(a, c)``: Goldilocks products (JAX:
  ``plonky2_tpu/fields/goldilocks.py`` ``mul`` and ``mul_const``), behind
  ``fields/goldilocks.mul`` and ``mul_const``;
- ``gl_mul_const(a, c, idx, off, table)``: a c times the constants of a
  table that the bits of an index select, in one launch (JAX: the
  ``subgroup_x`` and ``cosetStart`` loops of ``plonky2_tpu/fri/verify.py``,
  a product by a constant and a select a bit), behind
  ``fields/goldilocks.mul_const_bits``;
- ``qe_mul(a, b[, c])``: the quadratic-extension product a b, or a b + c
  (JAX: ``plonky2_tpu/fields/goldilocks_ext.py`` ``mul`` and ``mul_add``),
  behind ``fields/goldilocks_ext.mul`` and ``mul_add``;
- ``coset_interp_scan``: the interpolation gate's chunk steps (JAX: the
  ``jax.lax.scan`` of ``plonky2_tpu/gates/gates.py``
  CosetInterpolationGate.eval, and the gather of its values), behind
  ``gates/gates.coset_interp_scan``: the operands are the gate's wire
  columns, read by their strides, and the gate's host schedule goes into
  the launch by value (``scan_cells``).

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

MAX_DIMS = 4  # csrc/strided.cuh MAX_DIMS
MAX_BITS = 64  # csrc/goldilocks_mul.cu MAX_BITS
MAX_SCAN_LOG_SEG = 5  # csrc/goldilocks_mul.cu SCAN_MAX_LOG_SEG
MAX_SCAN_CELLS = 128  # SCAN_MAX_CELLS


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


def descriptor(shapes, strides, ptrs, what):
    """(lead shape, element count, the host words of csrc/strided.cuh's
    descriptor: n, ndim, dims, then each plane's pointer and strides) of
    planes given by their shapes, element strides and data pointers."""
    lead, dims, merged = broadcast_layout(shapes, strides)
    if len(dims) > MAX_DIMS:
        raise ValueError(f"{what}: {len(dims)} dimensions after merging "
                         f"(shapes {[tuple(s) for s in shapes]}), the "
                         f"kernel takes {MAX_DIMS}")
    pad = MAX_DIMS - len(dims)
    n = math.prod(lead)
    words = [n, len(dims), *dims, *([1] * pad)]
    for ptr, st in zip(ptrs, merged):
        words += [ptr, *st, *([0] * pad)]
    return lead, n, (ctypes.c_longlong * len(words))(*words)


def _descriptor(planes, what):
    """``descriptor`` of tensors over their broadcast."""
    return descriptor([t.shape for t in planes], [t.stride() for t in planes],
                      [t.data_ptr() for t in planes], what)


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


def gl_mul_const(a, c, idx=None, off=0, table=()):
    """a c for a GL value a and a python-int constant c (by value).  With a
    GL index ``idx`` and a ``table`` of 1 to 64 python ints, a c times each
    table[i] whose bit off + i of idx is set (off + len(table) <= 64), over
    the broadcast of a and idx; a may then be None, for 1."""
    planes = [] if a is None else [a[0], a[1]]
    n_bits = len(table)
    if idx is None:
        if a is None or n_bits:
            raise ValueError("product by a constant: a table needs an index, "
                             "and no index needs a")
        words = None
    else:
        if not 1 <= n_bits or off < 0 or off + n_bits > MAX_BITS:
            raise ValueError(f"product by a constant: bits {off} to "
                             f"{off + n_bits - 1} of the index, the kernel "
                             f"takes 1 to {MAX_BITS} bits below bit {MAX_BITS}")
        planes += [idx[0], idx[1]]
        words = (ctypes.c_uint64 * n_bits)(*(int(t) % P for t in table))
    out, launched = _launch("p2t_gl_mul_const", planes, 2,
                            "Goldilocks product by a constant",
                            int(a is not None), ctypes.c_uint64(int(c) % P),
                            words, off, n_bits)
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


def scan_cells(schedule):
    """The interpolation gate's host schedule (``CosetInterpolationGate
    .schedule``: xs, ws as GL (lo, hi) numpy pairs (deg, C), value indices
    and the active mask, numpy (deg, C)) -> (x, w, col, log_seg): the scan
    kernel's cells c S + j, S = 2^log_seg >= deg, as flat uint64, uint64
    and int32 arrays; col is the step's value column, -1 where the step is
    inactive or j >= deg."""
    xs, ws, vidx, active = schedule
    active = np.asarray(active, dtype=bool)
    deg, chunks = active.shape
    log_seg = (deg - 1).bit_length()  # S: the least power of two >= deg
    if log_seg > MAX_SCAN_LOG_SEG or chunks << log_seg > MAX_SCAN_CELLS:
        raise ValueError(f"interpolation scan: {deg} steps x {chunks} chunks,"
                         f" the kernel takes segments of at most "
                         f"{1 << MAX_SCAN_LOG_SEG} steps and "
                         f"{MAX_SCAN_CELLS} cells")
    seg = 1 << log_seg

    def cells(values, fill, dtype):
        out = np.full((chunks, seg), fill, dtype=dtype)
        out[:, :deg] = np.asarray(values).T
        return out.reshape(-1)

    def join(pair):
        lo, hi = (np.asarray(h, dtype=np.int64).astype(np.uint64)
                  for h in pair)
        return lo | (hi << np.uint64(32))

    col = np.where(active, np.asarray(vidx, dtype=np.int64), -1)
    return (cells(join(xs), 0, np.uint64), cells(join(ws), 0, np.uint64),
            cells(col, -1, np.int32), log_seg)


def scan_strides(inter_eval, inter_prod, values, pt, chunks):
    """(lanes, per plane (strides over (lane, column))) of the scan's
    operands, in the kernel's plane order: the intermediates' 16 planes (B,
    chunks - 1), pt's 8 (B, 1) or (B, chunks), the values' 8 (B, n); a
    stride is 0 along an axis of size 1.  Raises ValueError for other
    shapes."""
    groups = [(_ea_planes(inter_eval) + _ea_planes(inter_prod),
               (chunks - 1,), "intermediates"),
              (_ea_planes(pt), (1, chunks), "point"),
              (_ea_planes(values), None, "values")]
    lanes = values[0][0][0].shape[0] if values[0][0][0].dim() else 0
    out = []
    for planes, widths, what in groups:
        for t in planes:
            if (t.dim() != 2 or t.shape[0] not in (1, lanes)
                    or (widths is not None and t.shape[1] not in widths)):
                raise ValueError(f"interpolation scan: {what} of shape "
                                 f"{tuple(t.shape)} for {lanes} lanes and "
                                 f"{chunks} chunks")
            out.append(tuple(0 if n == 1 else st
                             for n, st in zip(t.shape, t.stride())))
    return lanes, out


def coset_interp_scan(inter_eval, inter_prod, values, pt, schedule):
    """The interpolation gate's chunk steps from its wires
    (``gates/gates.coset_interp_scan``): inter_eval, inter_prod EA (B,
    C - 1), the starts of chunks 1 .. C - 1 (chunk 0 starts at ev = 0, pr =
    1); values EA (B, n), the gate's value columns; pt EA (B, 1) or (B, C);
    schedule: the gate's host schedule (numpy, ``scan_cells``), passed by
    value in the launch -> (ev, pr) EA (B, C)."""
    planes = (_ea_planes(inter_eval) + _ea_planes(inter_prod)
              + _ea_planes(pt) + _ea_planes(values))
    device = _check(planes, "interpolation scan")
    x, w, col, log_seg = scan_cells(schedule)
    chunks = len(col) >> log_seg
    lanes, strides = scan_strides(inter_eval, inter_prod, values, pt, chunks)
    if col.max(initial=-1) >= values[0][0][0].shape[1]:
        raise ValueError(f"interpolation scan: value column {col.max()} of "
                         f"{values[0][0][0].shape[1]}")
    out = torch.empty((16, lanes, chunks), dtype=torch.int64, device=device)
    if lanes:
        words = [v for t, st in zip(planes, strides)
                 for v in (t.data_ptr(), *st)]
        desc = (ctypes.c_longlong * len(words))(*words)
        args = (desc, (ctypes.c_uint64 * len(x))(*x.tolist()),
                (ctypes.c_uint64 * len(w))(*w.tolist()),
                (ctypes.c_int * len(col))(*col.tolist()), lanes, chunks,
                log_seg)
        with torch.cuda.device(device):
            rc = build.library().p2t_coset_interp_scan(
                *args, out.data_ptr(), build.stream_handle(device))
        build.check(rc, "interpolation scan launch")
        coset_interp_scan.launches += 1
    planes = out.unbind(0)
    return _ea(planes[:8]), _ea(planes[8:])


gl_mul.launches = 0
gl_mul_const.launches = 0
qe_mul.launches = 0
coset_interp_scan.launches = 0
