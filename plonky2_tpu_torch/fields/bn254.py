"""BN254 scalar-field arithmetic on torch tensors: 16 x 16-bit limbs,
Montgomery domain (R = 2^256).

Counterpart of ``plonky2_tpu/fields/bn254.py``.  Elements are ``(..., 16)``
``int64`` tensors of little-endian 16-bit limbs, the reference's layout.  The
Montgomery product is CIOS with *redundant* column accumulators: 16 outer
steps slide a window over a 33-column accumulator, and only the current low
column has to be exact to form the quotient digit, so no carry chain runs
inside the loop.  One carry propagation and one conditional subtraction of p
give the canonical (< p) result.  ``mont_mul_sum`` reduces a sum of products
(e.g. one row of an MDS matrix) with a single REDC.
"""

from __future__ import annotations

import numpy as np
import torch

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
NUM_LIMBS = 16
LIMB_BITS = 16
R = 1 << 256
R_MOD_P = R % P
N0_INV = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

MASK = 0xFFFF
I64 = torch.int64

P_LIMBS = [(P >> (LIMB_BITS * k)) & MASK for k in range(NUM_LIMBS)]
_P_LIMBS_NP = np.asarray(P_LIMBS, dtype=np.int64)


# ---------------------------------------------------------------------------
# Host-side conversions (python ints / numpy)
# ---------------------------------------------------------------------------

def int_to_limbs(x):
    x = int(x) % P
    return [(x >> (LIMB_BITS * k)) & MASK for k in range(NUM_LIMBS)]


def limbs_to_int(limbs):
    out = 0
    for k in reversed(range(len(limbs))):
        out = (out << LIMB_BITS) | int(limbs[k])
    return out


def int_to_mont_limbs(x):
    return int_to_limbs((int(x) * R) % P)


# ---------------------------------------------------------------------------
# Limb normalisation
# ---------------------------------------------------------------------------

def _normalize(t):
    """Redundant columns (..., K) -> clean 16-bit limbs, plus the carry out of
    the top column.  Columns may be negative (borrows); ``>>`` floors.

    Parallel carry passes until no column carries: each pass moves every
    column's excess one position up, so the loop ends after at most K passes
    (two or three for products, where carries shrink 16 bits a pass)."""
    top = torch.zeros_like(t[..., 0])
    while True:
        c = t >> LIMB_BITS
        if not bool(torch.any(c != 0)):
            return t, top
        t = t & MASK
        t[..., 1:] += c[..., :-1]
        top = top + c[..., -1]


def _cond_sub_p(limbs):
    """Clean limbs of a value < 2p -> canonical (< p)."""
    p = torch.as_tensor(_P_LIMBS_NP, device=limbs.device)
    diff, borrow = _normalize(limbs - p)
    return torch.where((borrow == 0)[..., None], diff, limbs)


# ---------------------------------------------------------------------------
# Device ops
# ---------------------------------------------------------------------------

def mont_mul_sum(a, b, dim=None):
    """REDC(sum over ``dim`` of a * b): Montgomery product, or a sum of up
    to 4 Montgomery products, canonical.  a, b broadcast to (..., 16)."""
    a, b = torch.broadcast_tensors(a, b)
    # limb-major layout: the sliding window below then cuts contiguous rows
    a = a.movedim(-1, 0)
    b = b.movedim(-1, 0)
    if dim is not None:
        assert dim != -1, "the limb axis cannot be summed"
        dim = dim + 1  # the limb axis moved to the front
    out_shape = b.sum(dim=dim).shape[1:] if dim is not None else b.shape[1:]
    t = torch.zeros((2 * NUM_LIMBS + 1,) + tuple(out_shape), dtype=I64,
                    device=a.device)
    p = torch.as_tensor(_P_LIMBS_NP, device=a.device).reshape(
        (NUM_LIMBS,) + (1,) * len(out_shape))
    for i in range(NUM_LIMBS):
        prod = a[i:i + 1] * b
        if dim is not None:
            prod = prod.sum(dim=dim)
        w = t[i:i + NUM_LIMBS]
        w += prod
        m = (t[i] * N0_INV) & MASK
        w += m * p
        t[i + 1] += t[i] >> LIMB_BITS
    limbs, _ = _normalize(t[NUM_LIMBS:].movedim(0, -1))
    # result < 2p < 2^256, so the 17th column is zero after normalisation
    return _cond_sub_p(limbs[..., :NUM_LIMBS].contiguous())


def mont_mul(a, b):
    return mont_mul_sum(a, b)


def add(a, b):
    """Modular addition of canonical values (either domain)."""
    limbs, _ = _normalize(a + b)  # a + b < 2p < 2^255: no carry out
    return _cond_sub_p(limbs)


def eq(a, b):
    return torch.all(a == b, dim=-1)


def select(mask, a, b):
    return torch.where(mask[..., None], a, b)
