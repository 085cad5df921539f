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


@functools.lru_cache(maxsize=4)
def _kernel_consts(device):
    """Constant buffer of the kernel: Montgomery-form field elements as
    4 little-endian u64 words each, in the kernel's OFF_* order."""
    C = pb.consts()

    def words(limbs):  # (..., 16) 16-bit limbs -> (..., 4) u64 words
        limbs = np.asarray(limbs, dtype=np.uint64).reshape(-1, 4, 4)
        w = (limbs[..., 0] | (limbs[..., 1] << np.uint64(16))
             | (limbs[..., 2] << np.uint64(32)) | (limbs[..., 3] << np.uint64(48)))
        return w.reshape(-1)

    sparse = C["sparse"]  # (56, 4 j, 4 i, 16)
    s_row = sparse[:, :, 0]          # (56, 4): coefficients of new state 0
    s_col = sparse[:, 0, 1:]         # (56, 3): s0's coefficient in state k
    parts = [C["ark0"], C["ark_first"], C["ark_second"], C["m_mat"],
             C["p_mat"], C["part_c"], s_row, s_col]
    buf = np.concatenate([words(p) for p in parts])
    n_const = build.library().p2t_poseidon_bn254_n_const()
    if buf.size != 4 * n_const:
        raise build.KernelError(
            f"constant buffer has {buf.size // 4} elements, kernel wants {n_const}")
    return torch.from_numpy(buf.view(np.int64).copy()).to(device)


def permute(state):
    """state (..., 4, 16) int64 Montgomery limbs -> permuted, same shape."""
    if state.device.type == "cpu":
        return permute_plain(state)
    if state.device.type != "cuda":
        raise build.KernelError(f"no Poseidon-BN254 kernel for {state.device}")
    if state.dtype != torch.int64 or tuple(state.shape[-2:]) != (4, 16):
        raise ValueError(f"expected (..., 4, 16) int64, got {state.dtype} "
                         f"{tuple(state.shape)}")
    src = state.contiguous()
    out = torch.empty_like(src)
    n = src.numel() // 64
    consts = _kernel_consts(src.device)
    lib = build.library()
    rc = lib.p2t_poseidon_bn254_permute(
        src.data_ptr(), out.data_ptr(), consts.data_ptr(), n,
        build.stream_handle(src.device))
    build.check(rc, "poseidon_bn254 launch")
    permute.launches += 1
    return out


permute.launches = 0
