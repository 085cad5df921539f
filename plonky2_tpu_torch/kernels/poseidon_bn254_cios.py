"""Poseidon-BN254 permutation, CIOS variant: wrapper of the CUDA kernel
``csrc/poseidon_bn254_cios.cu``.

Replaces the Pallas TPU kernel ``plonky2_tpu/kernels/poseidon_bn254_pallas.py``
(``permute`` -> ``_kernel``), the all-vector-unit variant that the JAX
package runs under ``PLONKY2_TPU_PB_IMPL=cios``; ``hash/poseidon_bn254.permute``
selects it the same way.  The kernel runs one thread per permutation lane on
8 x 32-bit words, with fused multi-product Montgomery passes in a relaxed
[0, 2p) domain; it is bound by 32-bit integer multiply throughput (see the
source's header).  It computes the same function as kernel A
(``kernels/poseidon_bn254.py``), so its plain version is the same.

``permute`` launches the kernel for a CUDA tensor and raises if it cannot;
it takes the plain version (``permute_plain``) only for a CPU tensor.
``permute.launches`` counts kernel launches.
"""

from __future__ import annotations

import functools

import torch

from ..hash import poseidon_bn254 as pb
from . import build
from .poseidon_bn254 import check_state, const_words

permute_plain = pb.permute_plain


@functools.lru_cache(maxsize=4)
def _kernel_consts(device):
    """Constant buffer of the kernel: 8 little-endian u32 words a field
    element, in the kernel's OFF_* order."""
    words = const_words(build.library().p2t_poseidon_bn254_cios_n_const())
    return torch.from_numpy(words.copy()).to(device)


def permute(state):
    """state (..., 4, 16) int64 Montgomery limbs -> permuted, same shape."""
    if state.device.type == "cpu":
        return permute_plain(state)
    check_state(state, "Poseidon-BN254 CIOS")
    src = state.contiguous()
    out = torch.empty_like(src)
    consts = _kernel_consts(src.device)
    rc = build.library().p2t_poseidon_bn254_cios_permute(
        src.data_ptr(), out.data_ptr(), consts.data_ptr(), src.numel() // 64,
        build.stream_handle(src.device))
    build.check(rc, "poseidon_bn254_cios launch")
    permute.launches += 1
    return out


permute.launches = 0
