"""Poseidon-BN254 permutation: wrapper of the CUDA kernel
``csrc/poseidon_bn254.cu`` and its plain torch version.

Replaces the Pallas TPU kernel ``plonky2_tpu/kernels/poseidon_bn254_mxu.py``
(``permute`` -> ``_kernel``).  The kernel runs one thread per permutation
lane with the state in registers and CIOS Montgomery products on 64-bit
words; on the H100 it is bound by 64-bit integer multiply throughput (see
the source's header).  Next steps: the linear layers as int8 tensor-core
products; then a CUDA graph or a fused launch for the per-step and per-level
loops of ``fri/verify.py`` (reference ``plonky2_tpu/fri/verify.py:52-102``).

``permute`` launches the kernel for a CUDA tensor and raises if it cannot;
it takes the plain version (``permute_plain``) only for a CPU tensor.
``permute.launches`` counts kernel launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..hash import poseidon_bn254 as pb
from . import build

permute_plain = pb.permute_plain


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


def pack_words(limbs, bits, n_const):
    """(N, 16) 16-bit limbs -> int64 tensor of the little-endian ``bits``-bit
    words, checked against the kernel's constant count ``n_const``."""
    if limbs.shape[0] != n_const:
        raise build.KernelError(
            f"constant buffer has {limbs.shape[0]} elements, kernel wants {n_const}")
    per = bits // 16
    limbs = np.asarray(limbs, dtype=np.uint64).reshape(-1, 16 // per, per)
    words = np.zeros(limbs.shape[:-1], np.uint64)
    for k in range(per):
        words |= limbs[..., k] << np.uint64(16 * k)
    return words.reshape(-1)


@functools.lru_cache(maxsize=4)
def _kernel_consts(device):
    """Constant buffer of the kernel: 4 little-endian u64 words a field
    element."""
    words = pack_words(const_elements(), 64,
                       build.library().p2t_poseidon_bn254_n_const())
    return torch.from_numpy(words.view(np.int64).copy()).to(device)


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
    out = torch.empty_like(src)
    consts = _kernel_consts(src.device)
    rc = build.library().p2t_poseidon_bn254_permute(
        src.data_ptr(), out.data_ptr(), consts.data_ptr(), src.numel() // 64,
        build.stream_handle(src.device))
    build.check(rc, "poseidon_bn254 launch")
    permute.launches += 1
    return out


permute.launches = 0
