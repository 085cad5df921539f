"""Poseidon permutation over the BN254 scalar field (width 4, iden3 variant).

Counterpart of ``plonky2_tpu/hash/poseidon_bn254.py``: the Merkle-tree
hasher.  States are ``(..., 4, 16)`` int64 tensors of 16-bit limbs, always
in the Montgomery domain.  Round structure: ark0; 4 full rounds (the 4th
mixes with the P-matrix); 56 partial rounds with sparse S-maps; 4 full
rounds (the last adds no ark); S-box x^5.

``permute`` runs a hand-written CUDA kernel for a CUDA tensor (kernel A,
``kernels/poseidon_bn254.py``, or the CIOS kernel,
``kernels/poseidon_bn254_cios.py``, chosen by ``PLONKY2_TPU_PB_IMPL``) and
``permute_plain`` -- the torch version that follows ``_permute_jnp`` -- for a
CPU tensor.  Each partial round's sparse update is written as a 4x4
Montgomery-form matrix (identity terms use mont(1) = R mod p), so every
linear layer has one form.
"""

from __future__ import annotations

import contextlib
import functools
import os

import numpy as np
import torch

from ..fields import bn254
from . import poseidon_bn254_constants as K

FULL_ROUNDS = 8
PARTIAL_ROUNDS = 56
WIDTH = 4
RATE = 3


def _np_limbs(values):
    """Nested list of ints (already Montgomery form) -> int64 limb array."""
    return np.asarray(
        [[bn254.int_to_limbs(v) for v in row] for row in values]
        if isinstance(values[0], (list, tuple))
        else [bn254.int_to_limbs(v) for v in values], dtype=np.int64)


@functools.lru_cache(maxsize=1)
def consts():
    """The round schedule of ``pb._Consts.get()`` as numpy limb arrays, plus
    each partial round's sparse map as a full (4, 4) matrix ``sparse``."""
    c, s = K.C_CONSTANTS_MONT, K.S_CONSTANTS_MONT
    half = FULL_ROUNDS // 2
    ark_first = np.stack([
        _np_limbs([c[(i + 1) * WIDTH + k] for k in range(WIDTH)])
        for i in range(half)])                                  # (4, 4, 16)
    base = (half + 1) * WIDTH + PARTIAL_ROUNDS
    ark_second = np.stack(
        [_np_limbs([c[base + i * WIDTH + k] for k in range(WIDTH)])
         for i in range(half - 1)] + [np.zeros((WIDTH, 16), np.int64)])
    part_c = _np_limbs([c[(half + 1) * WIDTH + i]
                        for i in range(PARTIAL_ROUNDS)])        # (56, 16)
    one = bn254.R_MOD_P  # mont(1)
    sparse = []
    for i in range(PARTIAL_ROUNDS):
        # out_i = sum_j A[j][i] * st_j:  A[j][0] = s_row[j],
        # A[0][k] = s_col[k-1] and A[k][k] = mont(1) for k = 1..3
        a = [[0] * WIDTH for _ in range(WIDTH)]
        for j in range(WIDTH):
            a[j][0] = s[(WIDTH * 2 - 1) * i + j]
        for k in range(1, WIDTH):
            a[0][k] = s[(WIDTH * 2 - 1) * i + WIDTH + k - 1]
            a[k][k] = one
        sparse.append(_np_limbs(a))
    return dict(
        ark0=_np_limbs([c[k] for k in range(WIDTH)]),
        ark_first=ark_first, ark_second=ark_second, part_c=part_c,
        sparse=np.stack(sparse),                                # (56,4,4,16)
        m_mat=_np_limbs(K.M_MATRIX_MONT),                       # (4j, 4i, 16)
        p_mat=_np_limbs(K.P_MATRIX_MONT),
    )


# ---------------------------------------------------------------------------
# Plain version.  Inside the permutation values stay in a *relaxed* form:
# limbs 0..14 in [-1, 2^16 + 1], limb 15 unmasked, value in (-p/2^15, 2p),
# laid out (16 limbs, elements, lanes): a limb is one contiguous block, so a
# carry pass works on whole blocks and every matrix product is one 2-D
# product over the limbs.  A Montgomery product is then a fixed handful of
# whole-tensor ops:
#   T = a (x) b as 32 columns (the outer product in float64, then a fixed 0/1
#       matrix that sums each antidiagonal: |columns| < 2^37), or T = W s for
#       the linear layers (|columns| < 2^39); both exact below 2^53;
#   m = T mod R times -p^-1: T's low 16 bits and the rest of each column
#       times -p^-1's limbs as two exact float64 products (< 2^36 and
#       < 2^43; torch has no int64 matmul on the GPU), joined in int64 as
#       sum_i n'_(k-i) T_i (< 2^59); four carry passes (columns end in
#       [-1, 2^16]);
#   U = T + m p (float64 matmul, exact); U's low half is a multiple of R and
#       the carry out of it, sum U_k 2^(16k-256), is an integer < 2^26 that
#       a float64 dot recovers exactly by rounding;
#   result = U's high half + carry, relaxed by three carry passes.
# After every addition and linear layer ``_reduce_q`` subtracts
# floor(x/p - 0.01) * p (estimated in float64), keeping every value below
# 1.02 p, so every product stays below R p and REDC below 2p.  The output is
# normalised exactly and made canonical at the end, so it is bit-exact with
# the reference's canonical-everywhere path.
# ---------------------------------------------------------------------------

_NL = bn254.NUM_LIMBS
_M16 = bn254.MASK


@functools.lru_cache(maxsize=16)
def _plain_tables(device):
    """The plain permutation's constants: each matrix multiplies a (limbs,
    elements x lanes) operand from the left; each vector of limbs is laid
    out (16, elements, 1) to add to every lane."""
    P = bn254.P
    ninv = (-pow(P, -1, bn254.R)) % bn254.R
    nl = [(ninv >> (16 * k)) & _M16 for k in range(_NL)]
    pl = bn254.P_LIMBS
    ntoe = np.zeros((_NL, _NL), np.float64)       # m_k = sum_i n'_(k-i) T_i
    ptoe = np.zeros((2 * _NL, _NL), np.float64)   # (m p)_k = sum_i p_(k-i) m_i
    for i in range(_NL):
        for k in range(i, _NL):
            ntoe[k, i] = nl[k - i]
        for k in range(i, i + _NL):
            ptoe[k, i] = pl[k - i]
    conv = np.zeros((2 * _NL, _NL * _NL), np.float64)  # a_i b_j -> column i + j
    for i in range(_NL):
        for j in range(_NL):
            conv[i + j, i * _NL + j] = 1.0
    carry_w = np.asarray([[2.0 ** (16 * k - 256) for k in range(_NL)]])
    q_w = np.asarray([[(1 << (16 * k)) / P for k in range(_NL)]])

    def mat_w(m):
        """(4 j, 4 i, 16) constant limbs -> (128, 64) float64 with
        W[k*4 + i, a*4 + j] = M[j][i] limb (k - a)."""
        w = np.zeros((2 * _NL * WIDTH, _NL * WIDTH), np.float64)
        for j in range(WIDTH):
            for i in range(WIDTH):
                for a in range(_NL):
                    w[a * WIDTH + i:(a + _NL) * WIDTH + i:WIDTH,
                      a * WIDTH + j] = m[j, i]
        return w

    C = consts()

    def t(x):
        return torch.as_tensor(x, device=device)

    def limbs(x):
        """Constant limbs (..., elements, 16) -> (..., 16, elements, 1)."""
        return t(np.ascontiguousarray(np.swapaxes(x, -1, -2)[..., None]))

    return dict(
        ntoe=t(ntoe), ptoe=t(ptoe), conv=t(conv), carry_w=t(carry_w),
        q_w=t(q_w), p=t(np.asarray(pl, np.int64).reshape(_NL, 1, 1)),
        m_w=t(mat_w(C["m_mat"])), p_w=t(mat_w(C["p_mat"])),
        sparse_w=t(np.stack([mat_w(m) for m in C["sparse"]])),
        ark0=limbs(C["ark0"]), ark_first=limbs(C["ark_first"]),
        ark_second=limbs(C["ark_second"]),
        part_c=limbs(C["part_c"][:, None, :]))


def _mm(w, x):
    """w (M, K) times x (K, ...) over its leading axis -> (M, ...)."""
    return (w @ x.reshape(x.shape[0], -1)).view((w.shape[0],) + x.shape[1:])


def _relax(x, passes=3):
    """Carry passes over limbs 0..14 into 15 (axis 0), in place (value
    unchanged)."""
    low = x[:_NL - 1]
    up = x[1:]
    for _ in range(passes):
        c = low >> 16
        low &= _M16
        up += c
    return x


def _redc(T, tb):
    """T (32, elements, lanes) columns -> relaxed T * R^-1 (mod p), (16,
    elements, lanes)."""
    low = T[:_NL]
    m = ((_mm(tb["ntoe"], (low >> 16).double()).long() << 16)
         + _mm(tb["ntoe"], (low & _M16).double()).long())
    for _ in range(4):  # mod R: the carry out of limb 15 is dropped
        c = m >> 16
        m &= _M16
        m[1:] += c[:-1]
    U = T + _mm(tb["ptoe"], m.double()).long()
    U[_NL] += torch.round(_mm(tb["carry_w"], U[:_NL].double())[0]).long()
    return _relax(U[_NL:])


def _conv(a, b, tb):
    """Product columns of relaxed a, b (16, elements, lanes) -> (32,
    elements, lanes)."""
    o = a.double()[:, None] * b.double()[None]                # (16, 16, ...)
    return _mm(tb["conv"], o.reshape((_NL * _NL,) + a.shape[1:])).long()


def _mul(a, b, tb):
    return _redc(_conv(a, b, tb), tb)


def _linear(s, w, tb):
    """out_i = sum_j M[j][i] s_j through the (128, 64) matrix form of M; s
    (16, 4, lanes)."""
    return _redc(_mm(w, s.reshape(_NL * WIDTH, 1, -1).double()).long()
                 .view(2 * _NL, WIDTH, -1), tb)


def _reduce_q(x, tb):
    """Relaxed x (value < ~4p) -> relaxed x - q p with value in [0, 1.02p)."""
    q = torch.floor(_mm(tb["q_w"], x.double()) - 0.01).long()
    # limbs in (-2^18, 2^17 + 2) before the passes: two carry them back
    return _relax(x - q * tb["p"], passes=2)


def _exp5(x, tb):
    x2 = _mul(x, x, tb)
    x4 = _mul(x2, x2, tb)
    return _mul(x4, x, tb)


def permute_plain(state):
    """Torch permutation; state (..., 4, 16) int64 canonical Montgomery
    limbs -> the same, bit-exact with the reference."""
    tb = _plain_tables(state.device)
    lead = state.shape[:-2]
    s = state.reshape(-1, WIDTH, _NL).permute(2, 1, 0).contiguous()
    s = _reduce_q(s + tb["ark0"], tb)                       # (16, 4, lanes)
    for r in range(FULL_ROUNDS // 2):
        w = tb["p_w"] if r == FULL_ROUNDS // 2 - 1 else tb["m_w"]
        s = _reduce_q(_exp5(s, tb) + tb["ark_first"][r], tb)
        s = _reduce_q(_linear(s, w, tb), tb)
    for r in range(PARTIAL_ROUNDS):
        s0 = _reduce_q(_exp5(s[:, 0:1], tb) + tb["part_c"][r], tb)
        s = _reduce_q(_linear(torch.cat([s0, s[:, 1:]], dim=1),
                              tb["sparse_w"][r], tb), tb)
    for r in range(FULL_ROUNDS // 2):
        s = _reduce_q(_exp5(s, tb) + tb["ark_second"][r], tb)
        s = _reduce_q(_linear(s, tb["m_w"], tb), tb)
    s = s.permute(2, 1, 0).reshape(lead + (WIDTH, _NL))
    limbs, _ = bn254._normalize(s)  # value in [0, 1.02p): no carry out
    return bn254._cond_sub_p(limbs)


IMPLS = ("mxu", "cios")


def kernel_impl():
    """Which kernel ``permute`` runs on the GPU, read from
    ``PLONKY2_TPU_PB_IMPL`` at each call as the JAX package reads it:
    ``mxu`` (default) is kernel A (``csrc/poseidon_bn254.cu``, the
    counterpart of ``poseidon_bn254_mxu.py``), ``cios`` the CIOS kernel
    (``csrc/poseidon_bn254_cios.cu``, of ``poseidon_bn254_pallas.py``)."""
    impl = os.environ.get("PLONKY2_TPU_PB_IMPL", "mxu")
    if impl not in IMPLS:
        raise ValueError(f"PLONKY2_TPU_PB_IMPL={impl!r}: expected one of {IMPLS}")
    return impl


@contextlib.contextmanager
def use_impl(name):
    """Run the block with ``PLONKY2_TPU_PB_IMPL`` set to ``name``."""
    if name not in IMPLS:
        raise ValueError(f"{name!r}: expected one of {IMPLS}")
    old = os.environ.get("PLONKY2_TPU_PB_IMPL")
    os.environ["PLONKY2_TPU_PB_IMPL"] = name
    try:
        yield
    finally:
        if old is None:
            del os.environ["PLONKY2_TPU_PB_IMPL"]
        else:
            os.environ["PLONKY2_TPU_PB_IMPL"] = old


def permute(state):
    """Full permutation: the selected CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor under either setting."""
    if kernel_impl() == "cios":
        from ..kernels import poseidon_bn254_cios as kernel
    else:
        from ..kernels import poseidon_bn254 as kernel
    return kernel.permute(state)


def two_to_one(left, right):
    """Merkle node combine: permute([0, 0, left, right])[0]."""
    z = torch.zeros_like(left)
    return permute(torch.stack([z, z, left, right], dim=-2))[..., 0, :]


# ---------------------------------------------------------------------------
# Host-side helpers
# ---------------------------------------------------------------------------

def host_pack_gl_chunk(gl_values):
    """Pack <= 3 canonical GL ints into one BN254 int: sum v_k * 2^(64k)."""
    out = 0
    for k, v in enumerate(gl_values):
        out += int(v) << (64 * k)
    return out
