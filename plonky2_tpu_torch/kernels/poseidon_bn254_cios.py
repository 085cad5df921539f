"""Poseidon-BN254 permutation, CIOS variant: wrapper of the CUDA kernel
``csrc/poseidon_bn254_cios.cu``.

Replaces the Pallas TPU kernel ``plonky2_tpu/kernels/poseidon_bn254_pallas.py``
(``permute`` -> ``_kernel``), the all-vector-unit variant that the JAX
package runs under ``PLONKY2_TPU_PB_IMPL=cios``; ``hash/poseidon_bn254.permute``
selects it the same way.  The kernel computes on 9 limbs of 29 bits whose
products sum into 64-bit columns, with Montgomery reductions by 2^261, on a
group of four threads a lane for small launches and one thread a lane for
large ones (the launch picks by the lane count); it is bound by 32-bit
integer multiply-adds (see the source's header).  It computes the same
function as kernel A (``kernels/poseidon_bn254.py``), so its plain version
is the same.

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
from . import build
from .poseidon_bn254 import check_state, const_elements

permute_plain = pb.permute_plain

LIMBS, LIMB_BITS = 9, 29
SHIFT = 261 - 256  # the kernel's Montgomery radix 2^261 over the port's 2^256


def const_limbs(n_const):
    """``const_elements()`` in the kernel's domain: each constant c (Montgomery
    form, c = v 2^256 mod p) as c 2^5 mod p = v 2^261 mod p, in 9 little-endian
    29-bit limbs; an (n_const * 9,) int32 array, checked against the kernel's
    count ``n_const``."""
    els = const_elements()
    if els.shape[0] != n_const:
        raise build.KernelError(
            f"constant buffer has {els.shape[0]} elements, kernel wants {n_const}")
    mask = (1 << LIMB_BITS) - 1
    out = np.zeros((n_const, LIMBS), np.uint32)
    for i, limbs in enumerate(els):
        v = (bn254.limbs_to_int(limbs) << SHIFT) % bn254.P
        out[i] = [(v >> (LIMB_BITS * k)) & mask for k in range(LIMBS)]
    return out.reshape(-1).view(np.int32)


@functools.lru_cache(maxsize=16)
def _kernel_consts(device):
    """Constant buffer of the kernel (``const_limbs``), in its OFF_* order."""
    limbs = const_limbs(build.library().p2t_poseidon_bn254_cios_n_const())
    return torch.from_numpy(limbs.copy()).to(device)


def permute(state):
    """state (..., 4, 16) int64 Montgomery limbs -> permuted, same shape."""
    if state.device.type == "cpu":
        return permute_plain(state)
    check_state(state, "Poseidon-BN254 CIOS")
    src = state.contiguous()
    out = torch.empty_like(src)
    consts = _kernel_consts(src.device)
    with torch.cuda.device(src.device):  # the launch goes to the current device
        rc = build.library().p2t_poseidon_bn254_cios_permute(
            src.data_ptr(), out.data_ptr(), consts.data_ptr(), src.numel() // 64,
            build.stream_handle(src.device))
    build.check(rc, "poseidon_bn254_cios launch")
    permute.launches += 1
    return out


permute.launches = 0
