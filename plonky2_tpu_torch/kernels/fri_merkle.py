"""FRI's Poseidon-BN254 hash chains on the card: wrappers of the CUDA kernels
``csrc/fri_merkle.cu``.

They replace the two ``lax.scan`` loops of ``plonky2_tpu/fri/verify.py``
around the Pallas permutation (``_hash_leaves_scan`` at :101 and
``_merkle_chain`` at :68), which the port ran as one single-permutation
launch per absorb step and tree level: one launch now runs every chain of
a ``fri/merkle.merkle_plan`` side by side, each chain's state on chip from
its first absorb to its root.  ``chains_a`` runs kernel A's permutation
(``csrc/poseidon_bn254_a.cuh``), ``chains_cios`` the CIOS form's
(``csrc/poseidon_bn254_cios.cuh``); their plain version is
``fri/merkle.merkle_roots_plain``.

The chain kinds go to the kernel by value: the host descriptor
(``descriptor``) holds each operand's pointer and element strides, so the
leaf blocks, the siblings and the query index are read where they lie
(views of the batch, a query window) and nothing on the card is read for
the launch.  The kinds run longest chain first (``launch_order``).  The
output is allocated with ``torch.empty`` and the launch goes to the current
stream: nothing is made from host data and nothing waits for the device,
so the launch can be captured in the compiled verifier's CUDA graph.  The
wrappers take CUDA tensors only and raise ``build.KernelError`` for any
other device.  ``chains_a.launches`` and ``chains_cios.launches`` count
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from . import poseidon_bn254 as kb
from . import poseidon_bn254_cios as kc

MAX_KINDS = 8   # chain kinds a launch takes (csrc/fri_merkle.cu)
MASK_WORDS = 2  # a kind's slot-mask words in the descriptor
MAX_STEPS = 64 * MASK_WORDS // 3  # absorb steps a kind's mask holds


def launch_order(plan):
    """The plan's kinds, longest chain first (ties in plan order): blocks
    run in this order, so the launch's tail is short chains."""
    return sorted(range(len(plan)), key=lambda k: -plan[k].length)


def _strides(t, what, shape):
    """``t``'s element strides but the last; raise unless ``t`` is int64 of
    ``shape`` (None: any extent) with its 16 limbs contiguous."""
    if t.dtype != torch.int64 or t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"FRI chains: {what} is {t.dtype} "
                         f"{tuple(t.shape)}, expected int64 {shape}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"FRI chains: {what}'s limbs are not contiguous")
    return list(t.stride()[:-1])


def descriptor(plan, dev, x_index):
    """(device, (B, Q), the host descriptor's int64 words) of the plan's
    chains on the tensor dict ``dev`` and the query index ``x_index`` (a
    GL pair (B, Q) of 32-bit words): the head (kinds, B, Q, roots, then
    for the index's lo and hi words a pointer and its b, q strides), then
    per kind in ``launch_order`` the leaf blocks' pointer and b, q, step,
    slot strides, the siblings' pointer and b, q, level strides, steps,
    depth, bit offset, root column and the slot mask's words, the layout of
    ``csrc/fri_merkle.cu``'s ``parse``.  Raises ValueError on an operand of
    another dtype, shape or device than the index's."""
    lo, hi = x_index
    device = lo.device
    if len(plan) > MAX_KINDS or any(k.steps > MAX_STEPS for k in plan):
        raise ValueError(f"FRI chains: at most {MAX_KINDS} kinds of at most "
                         f"{MAX_STEPS} absorb steps, got "
                         f"{[k.steps for k in plan]}")
    B, Q = lo.shape
    words = [len(plan), B, Q, len(plan)]
    for name, w in (("index lo", lo), ("index hi", hi)):
        if w.device != device or w.dtype != torch.int64 or w.shape != (B, Q):
            raise ValueError(f"FRI chains: {name} is {w.dtype} "
                             f"{tuple(w.shape)} on {w.device}, expected "
                             f"int64 {(B, Q)} on {device}")
        words += [w.data_ptr(), *w.stride()]
    for k in launch_order(plan):
        kind = plan[k]
        leaves, sibs = kind.leaves(dev), kind.siblings(dev)
        for t in (leaves, sibs):
            if t.device != device:
                raise ValueError(f"FRI chains: {kind.name} on {t.device}, "
                                 f"the index on {device}")
        lead = _strides(leaves, f"{kind.name}'s leaf blocks",
                        (B, Q, max(kind.steps, 1), 3, 16))
        sib = _strides(sibs, f"{kind.name}'s siblings", (B, Q, None, 16))
        if sibs.shape[2] < kind.depth:
            raise ValueError(f"FRI chains: {kind.name} has "
                             f"{sibs.shape[2]} sibling levels, not "
                             f"{kind.depth}")
        mask = [(kind.mask >> (64 * i)) & ((1 << 64) - 1)
                for i in range(MASK_WORDS)]
        words += [leaves.data_ptr(), *lead, sibs.data_ptr(), *sib,
                  kind.steps, kind.depth, kind.offset, k,
                  *[m - (1 << 64) if m >> 63 else m for m in mask]]
    return device, (B, Q), words


def _launch(name, fn, plan, dev, x_index, tables):
    if x_index[0].device.type != "cuda":
        raise build.KernelError(f"no FRI chain kernel for {x_index[0].device}")
    device, (B, Q), words = descriptor(plan, dev, x_index)
    out = torch.empty((B, Q, len(plan), 16), dtype=torch.int64, device=device)
    if B * Q:
        tables = tables(device)
        desc = (ctypes.c_longlong * len(words))(*words)
        with torch.cuda.device(device):  # the launch goes to the current device
            rc = getattr(build.library(), name)(
                desc, out.data_ptr(), *(t.data_ptr() for t in tables),
                build.stream_handle(device))
        build.check(rc, f"{name} launch")
        fn.launches += 1
    return out


def chains_a(plan, dev, x_index):
    """Every chain's root, (B, Q, len(plan), 16) canonical Montgomery limbs
    (``fri/merkle.merkle_roots_plain``), in one launch of
    ``merkle_chains_a_kernel`` (kernel A's permutation)."""
    return _launch("p2t_merkle_chains_a", chains_a, plan, dev, x_index,
                   kb._kernel_tables)


def chains_cios(plan, dev, x_index):
    """As ``chains_a``, in one launch of ``merkle_chains_cios_kernel`` (the
    CIOS form: a group of 4 threads a chain below 8448 chains on the H100,
    a thread a chain above)."""
    return _launch("p2t_merkle_chains_cios", chains_cios, plan, dev, x_index,
                   lambda device: (kc._kernel_consts(device),))


chains_a.launches = 0
chains_cios.launches = 0
