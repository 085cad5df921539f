"""FRI's Poseidon-BN254 hash chains on the card: wrappers of the CUDA kernels
``csrc/fri_merkle.cu``.

They replace the two ``lax.scan`` loops of ``plonky2_tpu/fri/verify.py``
around the Pallas permutation (``_hash_leaves_scan`` at :101 and
``_merkle_chain`` at :68): one launch runs every chain of a
``fri/merkle.merkle_plan`` side by side, each chain's state on chip from
its first absorb to its root.  ``chains_a`` runs kernel A's permutation
(``csrc/poseidon_bn254_a.cuh``, its round matrices streamed through a ring
in shared memory by bulk copies, ``ring_matrices``), ``chains_cios`` the
CIOS form's (``csrc/poseidon_bn254_cios.cuh``); their plain version is
``fri/merkle.merkle_roots_plain``.

``launch_geometry`` lays a launch out from the plan, the lanes and the
device's SMs: its slot types (a lane slot runs its lane's chains of a
type's kinds back to back; ``fri/merkle.slot_plan``), the threads that
serve a lane and the blocks.  Every choice in it was measured on the H100
(``tools/chain_layouts``, ``PERF.md`` §6): kernel A's form runs two
threads a lane while the card has room and one above; the CIOS form a
group of 4 threads a lane while the card has room, one above, with the
kinds packed while that gives each SM at most one block.  ``limits``
reads what the compiled kernels hold (registers, spills, resident blocks
an SM), once a device and block size.  The chain kinds and slot types go to the kernel by value:
the host descriptor (``descriptor``) holds each operand's pointer and
element strides, so the leaf blocks, the siblings and the query index are
read where they lie (views of the batch, a query window) and nothing on
the card is read for the launch.  The output is allocated with
``torch.empty`` and the launch goes to the current stream: nothing is made
from host data and nothing waits for the device, so the launch can be
captured in the compiled verifier's CUDA graph.  The wrappers take CUDA
tensors only and raise ``build.KernelError`` for any other device.
``chains_a.launches`` and ``chains_cios.launches`` count kernel launches
(``launch``, which runs a given layout, counts on the form's wrapper).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..fri import merkle
from . import build
from . import poseidon_bn254 as kb
from . import poseidon_bn254_cios as kc

MAX_KINDS = 8   # chain kinds (and slot types) a launch takes
MASK_WORDS = 2  # a kind's slot-mask words in the descriptor
MAX_STEPS = 64 * MASK_WORDS // 3  # absorb steps a kind's mask holds
HEAD = 13       # the descriptor's head words
KIND_WORDS = 15  # a kind's words
THREADS = 128   # a block's threads
# Chains an SM while kernel A's form runs two threads a lane (the pair
# form): measured faster at 163 chains an SM (step B=128) and slower at 326
# (step B=256) than a thread a lane (PERF.md §6).
PAIR_LANES = 192
# Chains an SM while the CIOS form runs a group of 4 threads a lane:
# measured faster at 65 chains an SM (step B=51) and slower at 163.
GROUP_LANES = 96
# csrc/fri_merkle.cu's kernel of each form number (p2t_merkle_chains_info):
# kernel A's lane and pair forms, the CIOS group and lane forms.
KERNELS = {"a_lane": 0, "a_pair": 1, "cios_group": 2, "cios_lane": 3}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A chain launch's layout: ``form`` (``a`` or ``cios``), the slot
    ``types`` (tuples of plan indices, ``fri/merkle.slot_plan``), the
    threads a lane ``tpl`` (1, 2 for kernel A's pair form, 4 for the CIOS
    group form), ``threads`` a block (lanes a block: threads // tpl) and
    ``blocks`` in all."""
    form: str
    types: tuple
    tpl: int
    threads: int
    blocks: int

    @property
    def kernel(self):
        """The compiled kernel the launch runs (a key of ``KERNELS``)."""
        if self.form == "a":
            return "a_pair" if self.tpl == 2 else "a_lane"
        return "cios_group" if self.tpl == 4 else "cios_lane"

    def fill(self, plan):
        """The share of the slots' permutation steps that run a chain: the
        plan's permutations over the types times the longest type's."""
        longest = max(merkle.slot_length(plan, t) for t in self.types)
        total = sum(k.length for k in plan)
        return total / (len(self.types) * longest) if longest else 1.0


def layout(form, types, tpl, lanes):
    """The ``Geometry`` of ``form``'s launch over ``lanes`` lanes with slot
    ``types`` and ``tpl`` threads a lane: blocks of ``THREADS`` threads."""
    return Geometry(form, types, tpl, THREADS,
                    len(types) * -(-lanes * tpl // THREADS))


def launch_geometry(plan, lanes, form, sms):
    """The ``Geometry`` of a launch of ``form`` (``a`` or ``cios``) over
    ``lanes`` (B Q) lanes of ``plan`` on a device of ``sms`` SMs, blocks of
    ``THREADS`` threads, the types longest first.  Kernel A's form: a kind
    a type, on two threads a lane while the chains are at most
    ``PAIR_LANES`` an SM, else on one.  The CIOS form: a kind a type on a
    group of 4 threads a lane while the chains are at most ``GROUP_LANES``
    an SM; above, a thread a lane, and the kinds packed
    (``fri/merkle.slot_plan``) while that gives every SM at most one block
    (step B=128: 112 blocks, 9.43 ms against 10.98 with a kind a type and
    168 blocks on 132 SMs; PERF.md §6).  A pure function of its
    arguments."""
    chains = lanes * len(plan)
    types = merkle.slot_plan(plan)
    if form == "a":
        tpl = 2 if chains <= PAIR_LANES * sms else 1
    elif chains <= GROUP_LANES * sms:
        tpl = 4
    else:
        tpl = 1
        packed = merkle.slot_plan(plan, pack=True)
        if layout(form, packed, tpl, lanes).blocks <= sms:
            types = packed
    return layout(form, types, tpl, lanes)


@functools.lru_cache(maxsize=64)
def _limits(index, kernel, threads):
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(index):
        rc = build.library().p2t_merkle_chains_info(KERNELS[kernel], threads,
                                                   info)
    build.check(rc, "p2t_merkle_chains_info")
    return dict(zip(("sms", "resident", "registers", "spill_bytes",
                     "max_threads"), info))


def limits(device, kernel, threads):
    """{sms, resident (blocks an SM), registers, spill_bytes (local bytes a
    thread), max_threads (a block)} of ``kernel`` (a key of ``KERNELS``) at
    blocks of ``threads`` threads on the CUDA ``device``, from the runtime,
    read once a device and block size."""
    return _limits(torch.device(device).index or 0, kernel, threads)


def geometry(plan, lanes, form, device):
    """``launch_geometry`` on the CUDA ``device``."""
    return launch_geometry(
        plan, lanes, form,
        torch.cuda.get_device_properties(device).multi_processor_count)


@functools.lru_cache(maxsize=1)
def ring_matrices():
    """Kernel A's 64 round matrices as the chain kernel's ring takes them,
    (64, 128, 128) uint8: row r's 16-byte chunk c at chunk c ^ (r & 7), so
    a stage is one contiguous 16 KB copy and ldmatrix reads it without bank
    conflicts."""
    m = kb.round_matrices().reshape(64, 128, 8, 16)
    r = np.arange(128)[:, None]
    swz = m[:, r, np.arange(8)[None, :] ^ (r & 7)]
    swz.setflags(write=False)
    return swz.reshape(64, 128, 128)


@functools.lru_cache(maxsize=16)
def _ring_tables(device):
    """(constant words, ring matrices) of kernel A's chain form on
    ``device``."""
    return (kb._kernel_tables(device)[0],
            torch.from_numpy(ring_matrices().copy()).to(device))


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


def descriptor(plan, dev, x_index, geo):
    """(device, (B, Q), the host descriptor's int64 words) of the plan's
    chains on the tensor dict ``dev`` and the query index ``x_index`` (a
    GL pair (B, Q) of 32-bit words), laid out as ``geo``: the head (kinds,
    B, Q, roots, then for the index's lo and hi words a pointer and its b, q
    strides, then threads a block, threads a lane and slot types), then per
    kind in plan order the leaf blocks' pointer and b, q, step, slot
    strides, the siblings' pointer and b, q, level strides, steps, depth,
    bit offset, root column and the slot mask's words, then per slot type
    its kinds' count and indices: the layout of ``csrc/fri_merkle.cu``'s
    ``parse``.  Raises ValueError on an operand of another dtype, shape or
    device than the index's."""
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
    words += [geo.threads, geo.tpl, len(geo.types)]
    for k, kind in enumerate(plan):
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
    for t in geo.types:
        words += [len(t), *t]
    return device, (B, Q), words


def launch(geo, plan, dev, x_index):
    """Every chain's root, (B, Q, len(plan), 16) canonical Montgomery limbs,
    in one launch laid out as ``geo``: the main path's (``geometry``,
    through ``chains_a`` and ``chains_cios``) or another that
    ``tools/chain_layouts`` times beside it.  Counts the launch on
    ``chains_a`` or ``chains_cios``."""
    if x_index[0].device.type != "cuda":
        raise build.KernelError(f"no FRI chain kernel for {x_index[0].device}")
    device, (B, Q), words = descriptor(plan, dev, x_index, geo)
    out = torch.empty((B, Q, len(plan), 16), dtype=torch.int64, device=device)
    if B * Q:
        desc = (ctypes.c_longlong * len(words))(*words)
        lib = build.library()
        with torch.cuda.device(device):  # the launch goes to the current device
            if geo.form == "a":
                rc = lib.p2t_merkle_chains_a(
                    desc, out.data_ptr(),
                    *(t.data_ptr() for t in _ring_tables(device)),
                    build.stream_handle(device))
            else:
                rc = lib.p2t_merkle_chains_cios(
                    desc, out.data_ptr(), kc._kernel_consts(device).data_ptr(),
                    build.stream_handle(device))
        build.check(rc, f"merkle_chains_{geo.form} launch")
        (chains_a if geo.form == "a" else chains_cios).launches += 1
    return out


def _main_path(form, plan, dev, x_index):
    if x_index[0].device.type != "cuda":
        raise build.KernelError(f"no FRI chain kernel for {x_index[0].device}")
    B, Q = x_index[0].shape
    return launch(geometry(plan, B * Q, form, x_index[0].device), plan, dev,
                  x_index)


def chains_a(plan, dev, x_index):
    """Every chain's root, (B, Q, len(plan), 16) canonical Montgomery limbs
    (``fri/merkle.merkle_roots_plain``), in one launch of
    ``merkle_chains_a_kernel`` (kernel A's permutation, a block's warps
    sharing one ring of round matrices; two threads a lane while the chains
    are at most ``PAIR_LANES`` an SM, one above)."""
    return _main_path("a", plan, dev, x_index)


def chains_cios(plan, dev, x_index):
    """As ``chains_a``, in one launch of ``merkle_chains_cios_kernel`` (the
    CIOS form: a group of 4 threads a lane while the chains are at most
    ``GROUP_LANES`` an SM, a thread a lane above)."""
    return _main_path("cios", plan, dev, x_index)


chains_a.launches = 0
chains_cios.launches = 0
