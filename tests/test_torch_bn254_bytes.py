"""Kernel A's host side (``kernels/poseidon_bn254.py``): its round matrices
equal the JAX package's MXU matrices (``poseidon_bn254_mxu._mxu_consts``)
once the JAX byte order is mapped to natural order, and a Python-int model
of the tensor-core form of the permutation (byte rows times the round
matrix in int64, column recombination, Montgomery reduction, one
conditional subtraction) equals ``permute_plain``.  The model exists only in
this test; on the card the CUDA kernel is held against ``permute_plain``
(tests/test_torch_kernels_cuda.py, chip_smoke.py).  The arithmetic is
integer and exact: no tolerance applies.
"""
import numpy as np
import pytest
import torch

from plonky2_tpu.kernels import poseidon_bn254_mxu as jmxu
from plonky2_tpu_torch.fields import bn254
from plonky2_tpu_torch.hash import poseidon_bn254 as pb
from plonky2_tpu_torch.kernels import poseidon_bn254 as kb

torch.set_num_threads(1)
P, R = bn254.P, bn254.R
N_INV = (-pow(P, -1, R)) % R
R_INV = pow(R, -1, P)
HALF = pb.FULL_ROUNDS // 2


def test_round_matrices_equal_the_jax_mxu_matrices():
    K = jmxu._mxu_consts()
    jax_mats = np.concatenate([K["mats_first"], K["mats_partial"],
                               K["mats_second"]]).astype(np.float32)
    # JAX rows and columns of element j: [low bytes of its 16 limbs | high
    # bytes]; natural order: byte m of the little-endian element.
    perm = [m // 2 if m % 2 == 0 else 16 + m // 2 for m in range(32)]
    idx = [j * 32 + perm[m] for j in range(pb.WIDTH) for m in range(32)]
    natural = jax_mats[:, idx][:, :, idx]
    mats = kb.round_matrices()
    assert mats.shape == (64, 128, 128) and mats.dtype == np.uint8
    assert np.array_equal(mats.astype(np.float32), natural)


def _ints(limbs):
    return [bn254.limbs_to_int(x) for x in np.asarray(limbs)]


def _model_permute(lanes):
    """The tensor-core form on Python ints; lanes: list of 4 Montgomery ints."""
    C = pb.consts()
    ark0 = _ints(C["ark0"])
    ark_first = [_ints(a) for a in C["ark_first"]]
    ark_second = [_ints(a) for a in C["ark_second"]]
    part_c = _ints(C["part_c"])
    mats = kb.round_matrices().astype(np.int64)

    def sbox_ark(x, ark):  # x^5 in Montgomery form, plus the constant
        return pow(x, 5, P) * pow(R_INV, 4, P) % P + ark

    s = [[x + a for x, a in zip(lane, ark0)] for lane in lanes]  # < 2p
    for r in range(len(mats)):
        for st in s:
            if r < HALF:
                st[:] = [sbox_ark(x, a) for x, a in zip(st, ark_first[r])]
            elif r < HALF + pb.PARTIAL_ROUNDS:
                st[0] = sbox_ark(st[0], part_c[r - HALF])
            else:
                ark = ark_second[r - HALF - pb.PARTIAL_ROUNDS]
                st[:] = [sbox_ark(x, a) for x, a in zip(st, ark)]
        rows = np.asarray([[b for x in st for b in x.to_bytes(32, "little")]
                           for st in s], dtype=np.int64)   # every x < 2^256
        cols = rows @ mats[r].T                             # (lanes, 128)
        assert cols.max() < 1 << 23
        for st, col in zip(s, cols):
            for i in range(pb.WIDTH):
                v = sum(int(col[i * 32 + m]) << (8 * m) for m in range(32))
                assert v < (1 << 15) * P
                t = (v + (v % R) * N_INV % R * P) >> 256    # REDC
                assert t < P + (1 << 13)
                st[i] = t - P if t >= P else t
    return s


def test_tensor_core_model_equals_permute_plain():
    rng = np.random.default_rng(41)
    lanes = [[0, 1, P - 1, 2]]
    lanes += [[int.from_bytes(rng.bytes(32), "little") % P for _ in range(4)]
              for _ in range(7)]
    got = _model_permute(lanes)
    state = torch.as_tensor(np.asarray(
        [[bn254.int_to_limbs(x) for x in lane] for lane in lanes], np.int64))
    want = kb.permute_plain(state).numpy()
    assert [[bn254.limbs_to_int(x) for x in lane] for lane in want] == got


def test_const_words_are_the_elements_little_endian():
    """The packed constant buffer: 8 little-endian u32 words an element, in
    the order of ``const_elements``."""
    n = len(kb.const_elements())
    words = kb.const_words(n).view(np.uint32).reshape(n, 8)
    assert [sum(int(w) << (32 * k) for k, w in enumerate(row)) for row in words] \
        == _ints(kb.const_elements())


def test_const_words_checks_the_kernel_count():
    with pytest.raises(kb.build.KernelError):
        kb.const_words(len(kb.const_elements()) + 1)
