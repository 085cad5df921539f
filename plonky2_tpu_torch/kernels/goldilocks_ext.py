"""Quadratic-extension chains on the card: wrappers of the CUDA kernels in
``csrc/goldilocks_ext.cu``.

They replace the JAX package's ``jax.lax.scan`` chains of
``plonky2_tpu/fields/goldilocks_ext.py`` (``horner``, ``powers``, and
``inv`` through ``plonky2_tpu/fields/goldilocks.py`` ``inv``), which the
port's plain versions (``fields/goldilocks_ext.horner_plain``,
``powers_plain``, ``inv_plain``) unroll into a Python loop of several dozen
int64 torch ops a Goldilocks product.  Horner and powers split each lane's
chain over a group of G threads, G from ``chain_group``; the inverse runs
one thread an element (see the source's header for what bounds them).

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

MAX_GROUP = 32
# Threads a chain launch may take before the groups narrow: the card holds
# far more, but past this many the extra products for x^G and x^j cost more
# than the shorter chain saves (tuned on the H100, PERF.md).
THREAD_BUDGET = 32768


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


def chain_depth(n, group):
    """Dependent QE products of a chain of n steps split over ``group``
    threads: log2 G for x^G (x^j beside it), ceil(n / G) steps, 1 for the
    product by x^j; n for G = 1."""
    if group == 1:
        return n
    return group.bit_length() - 1 + -(-n // group) + 1


def chain_group(lanes, n):
    """The threads a lane's chain of n steps is split over: the power of two
    G <= min(32, max(n, 1)) with lanes x G <= THREAD_BUDGET whose chain is
    the shortest (``chain_depth``); the narrower of a tie."""
    best = 1
    g = 2
    while g <= min(MAX_GROUP, n) and lanes * g <= THREAD_BUDGET:
        if chain_depth(n, g) < chain_depth(n, best):
            best = g
        g *= 2
    return best


def _group(lanes, n, group):
    """``group``, or ``chain_group``'s when it is None; a power of two from
    1 to MAX_GROUP."""
    g = chain_group(lanes, n) if group is None else group
    if g not in [1 << s for s in range(MAX_GROUP.bit_length())]:
        raise ValueError(f"a chain's group must be a power of two from 1 to "
                         f"{MAX_GROUP}, got {g}")
    return g


def horner(terms, x, group=None):
    """sum_i terms[..., i] x^i: terms QE (..., n), x QE broadcastable to
    the lead shape -> QE of shape broadcast(terms' lead, x).  ``group``:
    the threads a lane, ``chain_group``'s by default."""
    tp, xp = _planes(terms), _planes(x)
    device = _check(tp + xp, "QE Horner")
    n = tp[0].shape[-1]
    lead = torch.broadcast_shapes(*(t.shape[:-1] for t in tp),
                                  *(t.shape for t in xp))
    tp = _fit(tp, lead + (n,))
    xp = _fit(xp, lead)
    out = _empty(lead, device)
    lanes = xp[0].numel()
    group = _group(lanes, n, group)
    with torch.cuda.device(device):  # the launch goes to the current device
        rc = build.library().p2t_qe_horner(
            *_ptrs(tp), *_ptrs(xp), *_ptrs(out), lanes, n, group,
            build.stream_handle(device))
    build.check(rc, "qe_horner launch")
    horner.launches += 1
    return _qe(out)


def powers(x, n, group=None):
    """[x^0, .., x^(n-1)]: x QE (...) -> QE (..., n).  ``group``: the
    threads a lane, ``chain_group``'s by default."""
    xp = _planes(x)
    device = _check(xp, "QE powers")
    lead = torch.broadcast_shapes(*(t.shape for t in xp))
    xp = _fit(xp, lead)
    out = _empty(lead + (n,), device)
    lanes = xp[0].numel()
    group = _group(lanes, n, group)
    with torch.cuda.device(device):
        rc = build.library().p2t_qe_powers(
            *_ptrs(xp), *_ptrs(out), lanes, n, group,
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
