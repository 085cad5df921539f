"""Quadratic-extension chains on the card: wrappers of the CUDA kernels in
``csrc/goldilocks_ext.cu``.

They replace the JAX package's ``jax.lax.scan`` chains of
``plonky2_tpu/fields/goldilocks_ext.py`` (``horner``, ``powers``, and
``inv`` through ``plonky2_tpu/fields/goldilocks.py`` ``inv``), which the
port's plain versions (``fields/goldilocks_ext.horner_plain``,
``powers_plain``, ``inv_plain``) unroll into a Python loop of several dozen
int64 torch ops a Goldilocks product.  Horner and powers split each lane's
chain over a group of G threads, G from ``chain_group``; the inverse
inverts a warp's elements at once (batch inversion), K elements a thread,
K from ``inv_per_thread`` (see the source's header for what bounds them).

A QE value is the port's four int64 planes of 32-bit halves, passed to the
kernel as they are.  The kernels read each input plane where it lies, by its
element strides over the broadcast lead shape (``goldilocks_mul.descriptor``,
0 along a broadcast axis; Horner's terms with a stride along n as well), so
a broadcast or strided operand costs no copy.  Each wrapper allocates its
output with ``torch.empty`` and launches on the current stream: nothing is
made from host data and nothing waits for the device, so the launches can
be captured in the compiled verifier's CUDA graph.  They take CUDA tensors
only and raise ``build.KernelError`` for any other device;
``fields/goldilocks_ext`` dispatches to the plain versions for CPU tensors.
``horner.launches``, ``powers.launches`` and ``inv.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .goldilocks_mul import _descriptor, descriptor

MAX_GROUP = 32
# Threads a chain launch may take before the groups narrow: the card holds
# far more, but past this many the extra products for x^G and x^j cost more
# than the shorter chain saves (tuned on the H100, PERF.md).
THREAD_BUDGET = 32768
# The inverse's elements a thread, and the threads a launch may take before
# a thread takes more: a warp's one inversion is spread over 32 K elements,
# but fewer warps hide less of a warp's latency (tuned on the H100,
# PERF.md).
INV_PER_THREAD = (1, 2, 4, 8)
INV_THREAD_BUDGET = 32768


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


def inv_per_thread(elements):
    """The inverse's elements a thread: the fewest of INV_PER_THREAD with
    which the launch takes at most INV_THREAD_BUDGET threads."""
    for k in INV_PER_THREAD:
        if -(-elements // k) <= INV_THREAD_BUDGET:
            return k
    return INV_PER_THREAD[-1]


def horner(terms, x, group=None):
    """sum_i terms[..., i] x^i: terms QE (..., n), x QE broadcastable to
    the lead shape -> QE of shape broadcast(terms' lead, x).  ``group``:
    the threads a lane, ``chain_group``'s by default."""
    tp, xp = _planes(terms), _planes(x)
    device = _check(tp + xp, "QE Horner")
    n = torch.broadcast_shapes(*(t.shape[-1:] for t in tp))[0]
    lead, lanes, desc = descriptor(
        [t.shape[:-1] for t in tp] + [t.shape for t in xp],
        [t.stride()[:-1] for t in tp] + [t.stride() for t in xp],
        _ptrs(tp + xp), "QE Horner")
    steps = (ctypes.c_longlong * 4)(
        *(0 if t.shape[-1] == 1 else t.stride(-1) for t in tp))
    out = _empty(lead, device)
    group = _group(lanes, n, group)
    with torch.cuda.device(device):  # the launch goes to the current device
        rc = build.library().p2t_qe_horner(
            desc, steps, *_ptrs(out), n, group, build.stream_handle(device))
    build.check(rc, "qe_horner launch")
    horner.launches += 1
    return _qe(out)


def powers(x, n, group=None):
    """[x^0, .., x^(n-1)]: x QE (...) -> QE (..., n).  ``group``: the
    threads a lane, ``chain_group``'s by default."""
    xp = _planes(x)
    device = _check(xp, "QE powers")
    lead, lanes, desc = _descriptor(xp, "QE powers")
    out = _empty(lead + (n,), device)
    group = _group(lanes, n, group)
    with torch.cuda.device(device):
        rc = build.library().p2t_qe_powers(
            desc, *_ptrs(out), n, group, build.stream_handle(device))
    build.check(rc, "qe_powers launch")
    powers.launches += 1
    return _qe(out)


def inv(a, per_thread=None):
    """a^-1 elementwise, 0 for 0: QE (...) -> QE (...).  ``per_thread``:
    the elements a thread, ``inv_per_thread``'s by default."""
    if per_thread is not None and per_thread not in INV_PER_THREAD:
        raise ValueError(f"the inverse's elements a thread must be one of "
                         f"{INV_PER_THREAD}, got {per_thread}")
    ap = _planes(a)
    device = _check(ap, "QE inverse")
    lead, elements, desc = _descriptor(ap, "QE inverse")
    k = inv_per_thread(elements) if per_thread is None else per_thread
    out = _empty(lead, device)
    with torch.cuda.device(device):
        rc = build.library().p2t_qe_inv(
            desc, *_ptrs(out), k, build.stream_handle(device))
    build.check(rc, "qe_inv launch")
    inv.launches += 1
    return _qe(out)


horner.launches = 0
powers.launches = 0
inv.launches = 0
