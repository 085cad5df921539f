"""FRI's Merkle-leaf absorb blocks on the card: the wrapper of the CUDA
kernel ``csrc/fri_leaves.cu``.

``leaf_blocks`` builds, in one launch, the blocks that FRI's chain kernels
absorb (``kernels/fri_merkle``) from the leaves the batch carries: each
initial oracle's ``init_leaves_<o>`` and each reduction step's
``step<j>_evals``, as ``fri/merkle.leaf_sources`` lays them out.  Its plain
version is ``fri/merkle.leaf_blocks_plain``.  The host descriptor
(``descriptor``) holds each word plane's pointer and element strides, so the
leaves are read where they lie (the widened batch, a query window); the
outputs are allocated with ``torch.empty`` and the launch goes to the
current stream: nothing is made from host data and nothing waits for the
device, so the launch can be captured in the compiled verifier's CUDA graph.
It takes CUDA tensors only and raises ``build.KernelError`` for any other
device.  ``leaf_blocks.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..fri import merkle
from . import build

MAX_SOURCES = 8  # leaves a launch takes
HEAD = 11        # the descriptor's head words
SOURCE_WORDS = 21  # a source's words
# R^2 mod p as 8 little-endian 32-bit words
R2_WORDS = [merkle.R2_LIMBS[2 * w] | merkle.R2_LIMBS[2 * w + 1] << 16
            for w in range(8)]


def outputs(spec, lead, device):
    """{block key: torch.empty int64 blocks} for ``spec``'s leaves over the
    ``lead`` (B, Q) lanes, contiguous: ``init_leaf_packed`` (B, Q, 4,
    max_steps, 3, 16), each ``step<j>_leaf_packed`` (B, Q, steps, 3,
    16)."""
    shapes = {s.block_key: (s.steps,) if s.oracle is None else (4, s.steps)
              for s in merkle.leaf_sources(spec)}
    return {k: torch.empty(tuple(lead) + shape + (3, 16), dtype=torch.int64,
                           device=device)
            for k, shape in shapes.items()}


def descriptor(spec, dev, out):
    """(device, the host descriptor's int64 words) of ``spec``'s leaves in
    the tensor dict ``dev`` into the blocks ``out`` (``outputs``): the head
    (sources, B, Q, ``R2_WORDS``), then per source in ``leaf_sources``
    order its blocks' pointer and lane stride, steps, elements and
    components an index, then for each word plane (lo, hi of c0, then of c1;
    4 planes' words, the unused zero) its pointer and b, q, element strides:
    the layout of ``csrc/fri_leaves.cu``'s ``parse``.  Raises ValueError on a
    plane of another dtype, shape or device than ``init_leaves_0``'s lanes
    and device."""
    sources = merkle.leaf_sources(spec)
    if len(sources) > MAX_SOURCES:
        raise ValueError(f"FRI leaf blocks: at most {MAX_SOURCES} leaves, got "
                         f"{len(sources)}")
    lead = dev["init_leaves_0"][0].shape[:2]
    device = dev["init_leaves_0"][0].device
    B, Q = lead
    words = [len(sources), B, Q, *R2_WORDS]
    for src in sources:
        blocks = out[src.block_key]
        if src.oracle is not None:
            blocks = blocks[:, :, src.oracle]
        lane = blocks.stride(1)
        if (blocks.dtype != torch.int64 or blocks.device != device
                or tuple(blocks.shape) != (B, Q, src.steps, 3, 16)
                or blocks.stride(0) != Q * lane
                or blocks.stride()[2:] != (48, 16, 1)):
            raise ValueError(f"FRI leaf blocks: {src.block_key} is "
                             f"{blocks.dtype} {tuple(blocks.shape)} on "
                             f"{blocks.device}, not dense int64 "
                             f"{(B, Q, src.steps, 3, 16)} on {device}")
        words += [blocks.data_ptr(), lane, src.steps, src.n, src.comps]
        planes = [w for pair in merkle.leaf_planes(src, dev) for w in pair]
        for w in planes:
            if (w.dtype != torch.int64 or w.device != device
                    or tuple(w.shape) != (B, Q, src.n // src.comps)):
                raise ValueError(f"FRI leaf blocks: {src.key} has a plane "
                                 f"{w.dtype} {tuple(w.shape)} on {w.device}, "
                                 f"expected int64 "
                                 f"{(B, Q, src.n // src.comps)} on {device}")
            words += [w.data_ptr(), *w.stride()]
        words += [0] * (4 * (4 - len(planes)))
    return device, words


def leaf_blocks(spec, dev):
    """{block key: blocks} of ``fri/merkle.leaf_blocks_plain``, bit for bit,
    in one launch of ``fri_leaf_blocks_kernel``."""
    device = dev["init_leaves_0"][0].device
    if device.type != "cuda":
        raise build.KernelError(f"no FRI leaf-block kernel for {device}")
    out = outputs(spec, dev["init_leaves_0"][0].shape[:2], device)
    device, words = descriptor(spec, dev, out)
    if words[1] * words[2]:
        desc = (ctypes.c_longlong * len(words))(*words)
        with torch.cuda.device(device):  # the launch goes to the current device
            rc = build.library().p2t_fri_leaf_blocks(
                desc, build.stream_handle(device))
        build.check(rc, "fri_leaf_blocks launch")
        leaf_blocks.launches += 1
    return out


leaf_blocks.launches = 0
