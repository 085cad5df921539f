"""Poseidon-BN254 permutation: wrapper of the CUDA kernel
``csrc/poseidon_bn254.cu`` (kernel A) and its plain torch version.

Replaces the Pallas TPU kernel ``plonky2_tpu/kernels/poseidon_bn254_mxu.py``
(``permute`` -> ``_kernel``).  As there, each round's linear layer is one
exact byte-matrix product, here on the int8 tensor cores: a lane's state as
128 bytes times the round's 128 x 128 byte matrix (``round_matrices``), then
one Montgomery reduction per element; the S-boxes and reductions run on the
CUDA cores, which bound it (see the source's header).

``permute`` launches the kernel for a CUDA tensor and raises if it cannot;
it takes the plain version (``permute_plain``) only for a CPU tensor.
``permute.launches`` counts kernel launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import bn254
from ..hash import poseidon_bn254 as pb
from ..hash import poseidon_bn254_constants as K
from . import build

permute_plain = pb.permute_plain

ROUND_BYTES = pb.WIDTH * 32  # a state as little-endian bytes


def const_elements():
    """The kernels' round constants, (N_CONST, 16) 16-bit Montgomery limbs in
    the OFF_* order of ``csrc/poseidon_bn254.cu`` and
    ``csrc/poseidon_bn254_cios.cu``: ark0, ark_first, ark_second, the M and
    P matrices ([j][i]), the partial rounds' constants, each partial round's
    sparse map as a row ``s_row`` (coefficients of new state 0) and a column
    ``s_col`` (s0's coefficient in state k)."""
    C = pb.consts()
    sparse = C["sparse"]  # (56, 4 j, 4 i, 16)
    parts = [C["ark0"], C["ark_first"], C["ark_second"], C["m_mat"],
             C["p_mat"], C["part_c"], sparse[:, :, 0], sparse[:, 0, 1:]]
    return np.concatenate([np.asarray(p).reshape(-1, 16) for p in parts])


def const_words(n_const):
    """``const_elements()`` as little-endian u32 words (an int32 array of
    8 a field element), checked against the kernel's count ``n_const``."""
    limbs = const_elements()
    if limbs.shape[0] != n_const:
        raise build.KernelError(
            f"constant buffer has {limbs.shape[0]} elements, kernel wants {n_const}")
    limbs = limbs.astype(np.uint32)
    return (limbs[:, 0::2] | (limbs[:, 1::2] << np.uint32(16))).reshape(-1).view(np.int32)


def _byte_matrix(coeffs):
    """coeffs[j][i] (Montgomery-form ints) of out_i = sum_j c_(j,i) s_j ->
    (128, 128) uint8 with [i*32 + m][j*32 + k] = byte m of c_(j,i) 2^(8k) mod p."""
    out = np.zeros((pb.WIDTH, 32, pb.WIDTH, 32), np.uint8)
    for j in range(pb.WIDTH):
        for i in range(pb.WIDTH):
            c = int(coeffs[j][i])
            if c == 0:
                continue
            for k in range(32):
                v = (c << (8 * k)) % bn254.P
                out[i, :, j, k] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    return out.reshape(ROUND_BYTES, ROUND_BYTES)


@functools.lru_cache(maxsize=1)
def round_matrices():
    """Kernel A's 64 round matrices, (64, 128, 128) uint8, in round order:
    4 full rounds (M, M, M, P), 56 partial rounds (each one's sparse map,
    identity terms mont(1) = R mod p), 4 full rounds (M).  Row = output byte,
    column = input byte, so a lane's bytes times row n sum to output column n
    (the tensor cores' col-major B operand)."""
    C_m, C_p, S = K.M_MATRIX_MONT, K.P_MATRIX_MONT, K.S_CONSTANTS_MONT
    m_mat, p_mat = _byte_matrix(C_m), _byte_matrix(C_p)
    w = pb.WIDTH
    partial = []
    for r in range(pb.PARTIAL_ROUNDS):
        row = S[(2 * w - 1) * r:(2 * w - 1) * r + w]           # c_(j,0)
        col = S[(2 * w - 1) * r + w:(2 * w - 1) * (r + 1)]     # c_(0,k), k > 0
        a = [[0] * w for _ in range(w)]
        for j in range(w):
            a[j][0] = row[j]
        for k in range(1, w):
            a[0][k] = col[k - 1]
            a[k][k] = bn254.R_MOD_P
        partial.append(_byte_matrix(a))
    half = pb.FULL_ROUNDS // 2
    mats = np.stack([m_mat] * (half - 1) + [p_mat] + partial + [m_mat] * half)
    mats.setflags(write=False)
    return mats


@functools.lru_cache(maxsize=16)
def _kernel_tables(device):
    """(constant words, round matrices) of kernel A on ``device``."""
    words = const_words(build.library().p2t_poseidon_bn254_n_const())
    return (torch.from_numpy(words.copy()).to(device),
            torch.from_numpy(round_matrices().copy()).to(device))


def check_state(state, what):
    """Raise unless ``state`` is a (..., 4, 16) int64 tensor on a CUDA device."""
    if state.device.type != "cuda":
        raise build.KernelError(f"no {what} kernel for {state.device}")
    if state.dtype != torch.int64 or tuple(state.shape[-2:]) != (4, 16):
        raise ValueError(f"expected (..., 4, 16) int64, got {state.dtype} "
                         f"{tuple(state.shape)}")


def permute(state):
    """state (..., 4, 16) int64 Montgomery limbs -> permuted, same shape."""
    if state.device.type == "cpu":
        return permute_plain(state)
    check_state(state, "Poseidon-BN254")
    src = state.contiguous()
    if src.data_ptr() % 16:  # the kernel reads two limbs at a time
        src = src.clone()
    out = torch.empty_like(src)
    consts, mats = _kernel_tables(src.device)
    with torch.cuda.device(src.device):  # the launch goes to the current device
        rc = build.library().p2t_poseidon_bn254_permute(
            src.data_ptr(), out.data_ptr(), consts.data_ptr(), mats.data_ptr(),
            src.numel() // 64, build.stream_handle(src.device))
    build.check(rc, "poseidon_bn254 launch")
    permute.launches += 1
    return out


permute.launches = 0
