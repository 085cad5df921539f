"""Quadratic-extension chains on the card: wrappers of the CUDA kernels in
``csrc/goldilocks_ext.cu``.

They replace the JAX package's ``jax.lax.scan`` chains of
``plonky2_tpu/fields/goldilocks_ext.py`` (``horner``, ``powers``, and
``inv`` through ``plonky2_tpu/fields/goldilocks.py`` ``inv``), which the
port's plain versions (``fields/goldilocks_ext.horner_plain``,
``powers_plain``, ``inv_plain``) unroll into a Python loop of several dozen
int64 torch ops a Goldilocks product.  Each kernel runs one thread a lane
(see the source's header for what bounds it).

A QE value is the port's four int64 planes of 32-bit halves, passed to the
kernel as they are.  Each wrapper broadcasts its operands to the lead shape
and makes each plane contiguous (a copy only where a plane is broadcast or
strided), allocates its output with ``torch.empty`` and launches on the
current stream: nothing is made from host data and nothing waits for the
device, so the launches can be captured in the compiled verifier's CUDA
graph.  They take CUDA tensors only and raise ``build.KernelError`` for any
other device; ``fields/goldilocks_ext`` dispatches to the plain versions for
CPU tensors.  ``horner.launches``, ``powers.launches`` and ``inv.launches``
count kernel launches.
"""

from __future__ import annotations

import torch

from . import build


def _planes(a):
    """QE value -> its four planes (lo0, hi0, lo1, hi1)."""
    return (a[0][0], a[0][1], a[1][0], a[1][1])


def _qe(planes):
    return ((planes[0], planes[1]), (planes[2], planes[3]))


def _check(planes, what):
    device = planes[0].device
    if device.type != "cuda":
        raise build.KernelError(f"no {what} kernel for {device}")
    for t in planes:
        if t.dtype != torch.int64 or t.device != device:
            raise ValueError(f"{what}: every plane must be int64 on "
                             f"{device}, got {t.dtype} on {t.device}")
    return device


def _fit(planes, shape):
    """Each plane broadcast to ``shape`` and contiguous."""
    return [t.expand(shape).contiguous() for t in planes]


def _empty(shape, device):
    return [torch.empty(shape, dtype=torch.int64, device=device)
            for _ in range(4)]


def _ptrs(planes):
    return [t.data_ptr() for t in planes]


def horner(terms, x):
    """sum_i terms[..., i] x^i: terms QE (..., n), x QE broadcastable to
    the lead shape -> QE of shape broadcast(terms' lead, x)."""
    tp, xp = _planes(terms), _planes(x)
    device = _check(tp + xp, "QE Horner")
    n = tp[0].shape[-1]
    lead = torch.broadcast_shapes(*(t.shape[:-1] for t in tp),
                                  *(t.shape for t in xp))
    tp = _fit(tp, lead + (n,))
    xp = _fit(xp, lead)
    out = _empty(lead, device)
    with torch.cuda.device(device):  # the launch goes to the current device
        rc = build.library().p2t_qe_horner(
            *_ptrs(tp), *_ptrs(xp), *_ptrs(out), xp[0].numel(), n,
            build.stream_handle(device))
    build.check(rc, "qe_horner launch")
    horner.launches += 1
    return _qe(out)


def powers(x, n):
    """[x^0, .., x^(n-1)]: x QE (...) -> QE (..., n)."""
    xp = _planes(x)
    device = _check(xp, "QE powers")
    lead = torch.broadcast_shapes(*(t.shape for t in xp))
    xp = _fit(xp, lead)
    out = _empty(lead + (n,), device)
    with torch.cuda.device(device):
        rc = build.library().p2t_qe_powers(
            *_ptrs(xp), *_ptrs(out), xp[0].numel(), n,
            build.stream_handle(device))
    build.check(rc, "qe_powers launch")
    powers.launches += 1
    return _qe(out)


def inv(a):
    """a^-1 elementwise, 0 for 0: QE (...) -> QE (...)."""
    ap = _planes(a)
    device = _check(ap, "QE inverse")
    shape = torch.broadcast_shapes(*(t.shape for t in ap))
    ap = _fit(ap, shape)
    out = _empty(shape, device)
    with torch.cuda.device(device):
        rc = build.library().p2t_qe_inv(
            *_ptrs(ap), *_ptrs(out), ap[0].numel(),
            build.stream_handle(device))
    build.check(rc, "qe_inv launch")
    inv.launches += 1
    return _qe(out)


horner.launches = 0
powers.launches = 0
inv.launches = 0
