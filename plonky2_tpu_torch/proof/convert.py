"""Conversions between the reference package's numpy layouts and the port's
tensors.

Two layouts hold a batched serde dict (numpy, as
``plonky2_tpu.proof.serde.stack_proofs`` or this package's ``stack_proofs``
returns it):

- the narrow layout, ``to_narrow``: the counterpart of the JAX package's
  ``proof_to_device_np``, the 32-bit words that its jitted program reads.
  Each uint64 Goldilocks array becomes its (lo, hi) words (QE arrays, with
  a trailing axis of 2, a pair of such pairs), each uint32 BN254 limb array
  stays as it is.  The words are int32 views of the batch's own bytes: no
  arithmetic and, for a uint64 array, no copy.
- the wide layout, ``widen``: the tensor dict that ``verify_device`` takes,
  each word widened to an int64 tensor holding its 32 bits.

``from_reference`` is ``widen`` of ``to_narrow``.  ``*_tovec`` chunks are
dropped from both (they enter the transcript through the observed sequence
built on the host), as are the Merkle leaves' absorb blocks
(``*_leaf_packed``: FRI builds them from the leaves, ``fri/merkle
.leaf_blocks``) and an ``ingest_batch`` batch's validity mask
(``verify_batch`` applies it on the host).  So every other key is the JAX
``proof_to_device_np``'s.

The compiled verifier keeps the narrow layout of its key in one flat int32
buffer: ``flat_layout`` gives each array's slot, ``pack`` copies a batch's
bytes into a host buffer of that layout, and ``narrow_views`` gives the
narrow leaves as views of such a buffer, on the host or on the card.

The ``gl_*`` / ``bn_*`` helpers convert single values at the parity
boundaries of the tests.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..fields import goldilocks as gl
from .serde import VALID_MASK

# the words of a uint64 are read from a little-endian view, lo first, and
# torch reads int32 in the host's byte order
if sys.byteorder != "little":
    raise ImportError("the narrow proof layout needs a little-endian host")

ALIGN = 32  # words: each slot of a flat buffer starts on 128 bytes


def gl_from_pair(pair, device="cpu"):
    """Reference GL pair (lo, hi) of uint32 arrays -> int64 tensor pair."""
    return (torch.as_tensor(np.asarray(pair[0]).astype(np.int64), device=device),
            torch.as_tensor(np.asarray(pair[1]).astype(np.int64), device=device))


def gl_to_pair(a):
    """int64 tensor pair -> reference GL pair of uint32 numpy arrays."""
    return (a[0].cpu().numpy().astype(np.uint32),
            a[1].cpu().numpy().astype(np.uint32))


def bn_from_limbs(limbs, device="cpu"):
    """(..., 16) uint32 Montgomery limbs -> int64 tensor."""
    return torch.as_tensor(np.asarray(limbs).astype(np.int64), device=device)


def bn_to_limbs(t):
    """int64 limb tensor -> (..., 16) uint32 numpy array."""
    return t.cpu().numpy().astype(np.uint32)


def _is_qe(key):
    return key.startswith("op_") or key == "final_poly" or key.endswith("_evals")


def _tree_map(fn, tree):
    """fn on every leaf of a nest of dicts and tuples, the nest kept."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, v) for v in tree)
    return fn(tree)


def narrow_leaf(key, words):
    """A uint64 array's words, (..., 2) int32 (numpy or torch) lo first ->
    its narrow leaf: (lo, hi), or for a QE array (``op_*``, ``final_poly``,
    ``*_evals``; trailing axis 2) ((lo, hi), (lo, hi)), each a view."""
    if _is_qe(key):
        return ((words[..., 0, 0], words[..., 0, 1]),
                (words[..., 1, 0], words[..., 1, 1]))
    return (words[..., 0], words[..., 1])


def split_words(arr):
    """numpy uint64 array -> (lo, hi) int32 views of its 32-bit words, the
    counterpart of the JAX package's ``_split_u64_np`` (which returns
    uint32 copies of the same bits)."""
    return narrow_leaf("", _words(arr))


def _words(arr):
    arr = np.asarray(arr)
    if arr.dtype != np.uint64:
        raise TypeError(f"expected uint64 words, got {arr.dtype}")
    return arr[..., None].view("<i4")


def _narrow(key, arr):
    arr = np.asarray(arr)
    if arr.dtype == np.uint64:
        return narrow_leaf(key, _words(arr))
    if arr.dtype == np.uint32:
        return arr.view(np.int32)
    raise TypeError(f"{key}: the proof layout has uint64 and uint32 "
                    f"arrays, not {arr.dtype}")


def device_arrays(batch_np):
    """The batch's arrays that reach the device: all but the mask, the
    ``*_tovec`` chunks and the ``*_leaf_packed`` blocks."""
    return {k: v for k, v in batch_np.items()
            if k != VALID_MASK and not k.endswith(("_tovec", "_leaf_packed"))}


def to_narrow(batch_np):
    """Batched serde dict (numpy) -> its narrow layout: of ``device_arrays``,
    key by key the leaves of the JAX ``proof_to_device_np``, as int32
    views."""
    return {k: _narrow(k, v) for k, v in device_arrays(batch_np).items()}


def widen(narrow, device="cpu"):
    """A nest of narrow leaves (int32 numpy arrays or tensors) -> the same
    nest of int64 tensors on ``device``, each word's 32 bits: one
    ``bitwise_and`` a leaf (the int32 word sign-extended, then masked),
    contiguous.  Plain torch on any device; ``widen(to_narrow(batch))`` is
    the tensor dict ``verify_device`` takes."""
    device = torch.device(device)
    mask = gl.device_table([gl.MASK32], device, np.int64)

    def one(words):
        words = torch.as_tensor(words, device=device)
        if words.dtype != torch.int32:
            raise TypeError(f"narrow leaves are int32, not {words.dtype}")
        return torch.bitwise_and(words, mask)

    return _tree_map(one, narrow)


def to_tensors(narrow, device="cpu"):
    """A nest of narrow leaves -> the same nest of int32 tensors on
    ``device``."""
    return _tree_map(lambda a: torch.as_tensor(a, device=device), narrow)


def from_reference(batch_np, device="cpu"):
    """Batched serde dict (numpy) -> the verifier's tensor dict:
    ``widen(to_narrow(batch_np), device)``.  Goldilocks arrays become
    (lo, hi) int64 pairs (QE arrays pairs of those), uint32 limb arrays
    int64 tensors."""
    return widen(to_narrow(batch_np), device)


# ---------------------------------------------------------------------------
# One flat int32 buffer of the narrow layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Slot:
    """An array's place in a flat int32 buffer: ``offset`` and ``words`` in
    32-bit words; the array's (``shape``, ``dtype``), uint64 or uint32."""
    name: str
    offset: int
    words: int
    shape: tuple
    dtype: np.dtype


def flat_layout(arrays):
    """{name: numpy array (uint64 or uint32)} -> (slots, length in words):
    the arrays laid end to end in one int32 buffer, in the dict's order,
    each slot starting at a multiple of ``ALIGN`` words."""
    slots, n = [], 0
    for name, a in arrays.items():
        a = np.asarray(a)
        if a.dtype not in (np.uint64, np.uint32):
            raise TypeError(f"{name}: {a.dtype} has no narrow layout")
        words = a.nbytes // 4
        slots.append(Slot(name, n, words, a.shape, a.dtype))
        n += -(-words // ALIGN) * ALIGN
    return tuple(slots), n


def pack(slots, host, arrays):
    """Copy each array's bytes into its slot of ``host``, a 1-D int32 tensor
    (or numpy array) of the layout's length: a copy, no arithmetic, made by
    torch, which splits a large copy over its threads.  The caller has
    checked every array's shape and dtype against its slot: ``copy_``
    would broadcast."""
    host = torch.as_tensor(host)
    for s in slots:
        a = np.asarray(arrays[s.name])
        if min(a.strides, default=0) < 0:
            a = np.ascontiguousarray(a)  # torch takes no negative stride
        wide = s.dtype == np.uint64
        words = host[s.offset:s.offset + s.words]
        words = words.view(torch.int64 if wide else torch.int32)
        words.view(s.shape).copy_(
            torch.from_numpy(a.view(np.int64 if wide else np.int32)))


def narrow_views(slots, flat):
    """{name: the narrow leaf of the slot's array}, each a view of ``flat``
    (a 1-D int32 numpy array or tensor of the layout's length)."""
    out = {}
    for s in slots:
        words = flat[s.offset:s.offset + s.words]
        if s.dtype == np.uint64:
            out[s.name] = narrow_leaf(s.name, words.reshape(s.shape + (2,)))
        else:
            out[s.name] = words.reshape(s.shape)
    return out
