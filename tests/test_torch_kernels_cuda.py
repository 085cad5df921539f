"""The hand-written CUDA kernels against their plain torch versions, on the
card.  They need an NVIDIA GPU and ``nvcc``, so every test here carries the
``cuda`` marker and skips where ``torch.cuda.is_available()`` is false.  On a
machine with a GPU (``--noconftest``: the suite's conftest imports jax, which
a GPU machine need not have):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The arithmetic is modular and integer, so every comparison is exact
(``torch.equal``): no tolerance applies.
"""
import numpy as np
import pytest
import torch

from plonky2_tpu_torch.fields import bn254
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.hash import poseidon_bn254 as pb
from plonky2_tpu_torch.kernels import poseidon_bn254 as kb
from plonky2_tpu_torch.kernels import poseidon_bn254_cios as kc
from plonky2_tpu_torch.kernels import poseidon_gl_transcript as kt
from plonky2_tpu_torch.proof.spec import load_circuit_spec
from plonky2_tpu_torch.transcript import challenger as chal

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bn_states(shape, seed):
    """Canonical Montgomery limbs; the first state holds 0, 1, p-1, 2."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 16, size=shape + (4, 16), dtype=np.int64)
    vals[..., 15] &= 0x1FFF  # < 2^253 < p
    flat = vals.reshape(-1, 4, 16)
    flat[0] = [bn254.int_to_limbs(v) for v in (0, 1, bn254.P - 1, 2)]
    return torch.as_tensor(vals)


@pytest.mark.parametrize("shape", [(1,), (3, 2), (1000,)])
def test_poseidon_bn254_kernel_matches_plain(dev, shape):
    st = _bn_states(shape, seed=len(shape) * 1000 + shape[0]).to(dev)
    before = kb.permute.launches
    got = kb.permute(st)
    assert kb.permute.launches == before + 1
    want = kb.permute_plain(st)
    torch.cuda.synchronize()
    assert got.shape == st.shape and torch.equal(got, want)


def test_poseidon_bn254_kernel_takes_strided_input(dev):
    st = _bn_states((5, 3), seed=7).to(dev).transpose(0, 1)
    assert not st.is_contiguous()
    assert torch.equal(kb.permute(st), kb.permute_plain(st.contiguous()))


def test_poseidon_bn254_kernel_rejects_other_dtypes(dev):
    with pytest.raises(ValueError):
        kb.permute(torch.zeros((2, 4, 16), dtype=torch.int32, device=dev))


@pytest.mark.parametrize("shape", [(1,), (3, 2), (1000,)])
def test_poseidon_bn254_cios_kernel_matches_plain(dev, shape):
    st = _bn_states(shape, seed=len(shape) * 2000 + shape[0]).to(dev)
    before = kc.permute.launches
    got = kc.permute(st)
    assert kc.permute.launches == before + 1
    want = kc.permute_plain(st)
    torch.cuda.synchronize()
    assert got.shape == st.shape and torch.equal(got, want)


def test_poseidon_bn254_cios_kernel_rejects_other_dtypes(dev):
    with pytest.raises(ValueError):
        kc.permute(torch.zeros((2, 4, 16), dtype=torch.int32, device=dev))


def test_permute_selects_the_kernel_by_env(dev, monkeypatch):
    st = _bn_states((4,), seed=11).to(dev)
    counts = (kb.permute.launches, kc.permute.launches)
    monkeypatch.setenv("PLONKY2_TPU_PB_IMPL", "cios")
    got_c = pb.permute(st)
    monkeypatch.setenv("PLONKY2_TPU_PB_IMPL", "mxu")
    got_a = pb.permute(st)
    assert (kb.permute.launches, kc.permute.launches) == (counts[0] + 1,
                                                         counts[1] + 1)
    assert torch.equal(got_c, got_a)


def test_transcript_kernel_matches_plain(dev):
    spec = load_circuit_spec("testdata/decode_block/common_circuit_data.json")
    schedule = chal.build_schedule(spec)
    rng = np.random.default_rng(3)
    obs = rng.integers(0, gl.P, size=(3, schedule.n_obs), dtype=np.uint64)
    obs[0, :3] = [0, 1, gl.P - 1]
    pi = rng.integers(0, gl.P, size=(3, 4), dtype=np.uint64)
    obs, pi = gl.split_u64(obs, dev), gl.split_u64(pi, dev)
    before = kt.run_transcript_kernel.launches
    got = chal.run_transcript(schedule, obs, pi)
    assert kt.run_transcript_kernel.launches == before + 1
    want = kt.run_transcript_plain(schedule, obs, pi)
    torch.cuda.synchronize()
    assert got[0].shape == (schedule.n_perms, 3, 12)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
