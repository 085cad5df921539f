"""The CIOS Poseidon-BN254 kernel's CPU path against the JAX package's CIOS
Pallas kernel (``plonky2_tpu/kernels/poseidon_bn254_pallas.py``), run in
interpret mode as tests/test_pallas_kernels.py runs it, on the same
numpy-seeded canonical states; and the kernel choice by
``PLONKY2_TPU_PB_IMPL``.  The CUDA kernel itself is held against the same
plain version on the card (tests/test_torch_kernels_cuda.py).  The arithmetic
is modular and integer, so every comparison is exact: no tolerance applies.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_tpu.kernels import poseidon_bn254_pallas as jpk
from plonky2_tpu_torch.fields import bn254
from plonky2_tpu_torch.hash import poseidon_bn254 as pb
from plonky2_tpu_torch.kernels import build
from plonky2_tpu_torch.kernels import poseidon_bn254_cios as kc

torch.set_num_threads(1)
LANES = 128  # one lane tile of the interpret-mode kernel, no padding


@pytest.fixture(scope="module")
def states():
    """(LANES, 4, 16) canonical Montgomery limbs; lane 0 holds 0, 1, p-1, 2
    and lane 1 holds p-1 four times."""
    rng = np.random.default_rng(29)
    ints = [[int(x) for x in row]
            for row in rng.integers(0, 1 << 62, size=(LANES, 4))]
    ints = [[v * (v + 7) ** 3 % bn254.P for v in row] for row in ints]
    ints[0] = [0, 1, bn254.P - 1, 2]
    ints[1] = [bn254.P - 1] * 4
    return np.asarray([[bn254.int_to_mont_limbs(v) for v in row]
                       for row in ints], dtype=np.uint32)


@pytest.fixture(scope="module")
def jax_cios(states):
    return np.asarray(jpk.permute(jnp.asarray(states), interpret=True))


def test_cios_plain_matches_jax_cios_kernel(states, jax_cios):
    got = kc.permute(torch.as_tensor(states.astype(np.int64)))  # CPU -> plain
    assert got.shape == (LANES, 4, 16)
    assert np.array_equal(got.numpy().astype(np.uint32), jax_cios)


def test_permute_under_cios_on_cpu_tensor(states, jax_cios, monkeypatch):
    monkeypatch.setenv("PLONKY2_TPU_PB_IMPL", "cios")
    st = torch.as_tensor(states.astype(np.int64)).reshape(2, LANES // 2, 4, 16)
    got = pb.permute(st)
    assert np.array_equal(got.reshape(LANES, 4, 16).numpy().astype(np.uint32),
                          jax_cios)


@pytest.mark.parametrize("value", ["", "CIOS", "jnp"])
def test_unknown_impl_raises(monkeypatch, value):
    monkeypatch.setenv("PLONKY2_TPU_PB_IMPL", value)
    with pytest.raises(ValueError):
        pb.permute(torch.zeros((1, 4, 16), dtype=torch.int64))


def test_default_impl_is_mxu(monkeypatch):
    monkeypatch.delenv("PLONKY2_TPU_PB_IMPL", raising=False)
    assert pb.kernel_impl() == "mxu"
    monkeypatch.setenv("PLONKY2_TPU_PB_IMPL", "cios")
    assert pb.kernel_impl() == "cios"


def test_cios_wrapper_has_no_fallback_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device launches
    the CUDA kernel or raises (here a meta tensor, which has no kernel)."""
    st = torch.zeros((2, 4, 16), dtype=torch.int64, device="meta")
    with pytest.raises(build.KernelError):
        kc.permute(st)
