"""Poseidon permutation over Goldilocks (width 12, plonky2 instance).

Counterpart of ``plonky2_tpu/hash/poseidon_gl.py``: the Fiat-Shamir
transcript's and the public-input hash's permutation.  States are GL values
of shape ``(..., 12)``.  Round structure (plonky2's "fast partial rounds"):

  full rounds:     +round-const, x^7 sbox, circulant MDS      (4 + 4 rounds)
  partial rounds:  folded first-constant layer + init matrix, then per round
                   a single x^7 sbox on lane 0 and a sparse w_hat/v update

The constant tables are imported from the reference package's generated
data module (plain literals, no imports), so the two packages cannot drift
apart.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import goldilocks as gl
from . import poseidon_gl_constants as K

WIDTH = 12
RATE = 8
HASH_SIZE = 4
HALF_N_FULL_ROUNDS = 4
N_PARTIAL_ROUNDS = 22


@functools.lru_cache(maxsize=1)
def consts():
    """Host constant bundle (numpy), the same schedule as ``pgl._Consts``."""
    rc = np.asarray(K.ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(30, 12)
    circ, diag = K.MDS_MATRIX_CIRC, K.MDS_MATRIX_DIAG
    mds = np.zeros((WIDTH, WIDTH), dtype=np.int64)
    for r in range(WIDTH):
        for c in range(WIDTH):
            mds[r][c] = circ[(c - r) % WIDTH] + (diag[r] if r == c else 0)
    m12 = [[0] * WIDTH for _ in range(WIDTH)]
    m12[0][0] = 1
    for d in range(11):
        for r in range(11):
            m12[1 + d][1 + r] = int(K.FAST_PARTIAL_ROUND_INITIAL_MATRIX[r][d])
    return dict(
        mds=mds,
        part_const_int=[int(x) for x in K.FAST_PARTIAL_ROUND_CONSTANTS],
        rc_first=gl.const_array(rc[:4].tolist()),
        rc_second=gl.const_array(rc[26:30].tolist()),
        first_const=gl.const_array(K.FAST_PARTIAL_FIRST_ROUND_CONSTANT),
        part_const=gl.const_array(K.FAST_PARTIAL_ROUND_CONSTANTS),
        init_mat12=gl.const_array(m12),
        w_full=gl.const_array([[K.MDS0TO0] + [int(x) for x in row]
                               for row in K.FAST_PARTIAL_ROUND_W_HATS]),
        vs_full=gl.const_array([[0] + [int(x) for x in row]
                                for row in K.FAST_PARTIAL_ROUND_VS]),
    )


def _sbox(x):
    """x^7 (plain torch on any device: the card runs this permutation in
    the transcript kernel)."""
    x2 = gl.mul_plain(x, x)
    x3 = gl.mul_plain(x, x2)
    x6 = gl.mul_plain(x3, x3)
    return gl.mul_plain(x, x6)


def _mds_layer(state):
    """Circulant MDS, state GL (..., 12).  Entries are <= 49, so each 32-bit
    half times the matrix sums below 2^42 and one reduction suffices."""
    a = gl.device_table(consts()["mds"], state[0].device)
    lo = (state[0][..., None, :] * a).sum(-1)
    hi = (state[1][..., None, :] * a).sum(-1)
    return gl.reduce_digits([lo, torch.zeros_like(lo), hi])


def _row(c, r, like):
    return gl.const_like((c[0][r], c[1][r]), like)


def permute(state):
    """Poseidon permutation; state GL (..., 12), canonical -> same."""
    C = consts()
    like = state[0]
    for r in range(HALF_N_FULL_ROUNDS):
        state = _mds_layer(_sbox(gl.add(state, _row(C["rc_first"], r, like))))

    state = gl.add(state, gl.const_like(C["first_const"], like))
    state = gl.matmul_const(state, C["init_mat12"])

    for r in range(N_PARTIAL_ROUNDS):
        s0 = _sbox((state[0][..., :1], state[1][..., :1]))
        pc = C["part_const_int"][r]
        s0 = gl.add(s0, gl.from_int(pc, (), like.device))
        st0 = gl.concat([s0, (state[0][..., 1:], state[1][..., 1:])])
        # d = MDS0TO0 * s0 + sum_i rest[i] * w_hat[i]
        d = gl.dot(st0, _row(C["w_full"], r, like))
        # rest[i] += s0 * vs[i]   (vs_full[0] = 0 keeps lane 0 as is)
        rest = gl.mul_add(s0, _row(C["vs_full"], r, like), st0)
        state = gl.concat([(d[0][..., None], d[1][..., None]),
                           (rest[0][..., 1:], rest[1][..., 1:])])

    for r in range(HALF_N_FULL_ROUNDS):
        state = _mds_layer(_sbox(gl.add(state, _row(C["rc_second"], r, like))))
    return state


def hash_no_pad(inputs, n_outputs=HASH_SIZE):
    """HashNoPad: one launch of the transcript kernel on a CUDA tensor
    (``kernels/poseidon_gl_transcript.hash_no_pad_kernel``), the plain
    version on a CPU tensor."""
    if inputs[0].device.type == "cpu":
        return hash_no_pad_plain(inputs, n_outputs)
    from ..kernels import poseidon_gl_transcript as kernel
    return kernel.hash_no_pad_kernel(inputs, n_outputs)


def hash_no_pad_plain(inputs, n_outputs=HASH_SIZE):
    """HashNoPad: absorb in rate-8 chunks (overwrite), squeeze n_outputs.

    inputs: GL (..., n) -> GL (..., n_outputs); empty input gives zeros."""
    assert n_outputs <= RATE
    n = inputs[0].shape[-1]
    batch = tuple(inputs[0].shape[:-1])
    state = gl.zeros(batch + (WIDTH,), inputs[0].device)
    for i in range(0, n, RATE):
        k = min(RATE, n - i)
        state = gl.concat([(inputs[0][..., i:i + k], inputs[1][..., i:i + k]),
                           (state[0][..., k:], state[1][..., k:])])
        state = permute(state)
    return (state[0][..., :n_outputs], state[1][..., :n_outputs])
