"""Conversions between the reference package's numpy layouts and the port's
tensors.

``from_reference`` turns a batched serde dict (numpy, as
``plonky2_tpu.proof.serde.stack_proofs`` or this package's ``stack_proofs``
returns it) into the tensor dict the verifier consumes: uint64 Goldilocks
arrays become (lo, hi) int64 pairs (QE arrays pairs of those), uint32
BN254 limb arrays become int64 limb tensors.  The ``gl_*`` / ``bn_*``
helpers convert single values at the parity boundaries of the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import goldilocks as gl
from .serde import VALID_MASK


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


def from_reference(batch_np, device="cpu"):
    """Batched serde dict (numpy) -> the verifier's tensor dict.

    QE arrays (``op_*``, ``final_poly``, ``step*_evals``; trailing axis 2)
    become pairs of GL pairs; other uint64 arrays GL pairs; ``*_tovec``
    chunks are dropped (they enter the transcript through the observed
    sequence built on the host), as is an ``ingest_batch`` batch's validity
    mask (``verify_batch`` applies it on the host); uint32 limb arrays become
    int64 tensors."""
    dev = {}
    for k, v in batch_np.items():
        if k == VALID_MASK:
            continue
        v = np.asarray(v)
        if v.dtype == np.uint64:
            if k.endswith("_tovec"):
                continue
            if _is_qe(k):
                dev[k] = (gl.split_u64(v[..., 0], device),
                          gl.split_u64(v[..., 1], device))
            else:
                dev[k] = gl.split_u64(v, device)
        else:
            dev[k] = torch.as_tensor(v.astype(np.int64), device=device)
    return dev
