"""Poseidon parity: the port's plain Poseidon-GL permutation and HashNoPad,
and its plain Poseidon-BN254 permutation (the CPU path of the CUDA kernel's
wrapper), against the JAX package on the same inputs, plus the golden
vectors of test_poseidon_gl.py and test_bn254.py.  The arithmetic is modular
and integer, so every comparison is exact: no tolerance applies.

The BN254 reference is ``poseidon_bn254._permute_jnp``, the jnp path that
the JAX package's own kernel tests hold its Pallas kernels against."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plonky2_tpu.hash import poseidon_bn254 as jpb
from plonky2_tpu.hash import poseidon_gl as jpgl
from plonky2_tpu_torch.fields import bn254
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.hash import poseidon_bn254 as pb
from plonky2_tpu_torch.hash import poseidon_gl as pgl
from plonky2_tpu_torch.kernels import build
from plonky2_tpu_torch.kernels import poseidon_bn254 as kb

torch.set_num_threads(1)
P = gl.P


def jpack(vals):
    vals = np.asarray(vals, dtype=np.uint64)
    return (jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((vals >> np.uint64(32)).astype(np.uint32)))


def junpack(a):
    return (np.asarray(a[0], np.uint64)
            | (np.asarray(a[1], np.uint64) << np.uint64(32)))


ZERO_PERM_OUT = [
    4330397376401421145, 14124799381142128323, 8742572140681234676,
    14345658006221440202, 15524073338516903644, 5091405722150716653,
    15002163819607624508, 2047012902665707362, 16106391063450633726,
    4680844749859802542, 15019775476387350140, 1698615465718385111,
]


def test_poseidon_gl_permute_matches_reference():
    rng = np.random.default_rng(17)
    st = rng.integers(0, P, size=(4, 12), dtype=np.uint64)
    st[0] = 0
    st[1, :3] = [0, 1, P - 1]
    st[2] = P - 1
    got = gl.join_u64(pgl.permute(gl.split_u64(st)))
    want = junpack(jax.jit(jpgl.permute)(jpack(st)))
    assert np.array_equal(got, want)
    assert got[0].tolist() == ZERO_PERM_OUT


@pytest.mark.parametrize("n", [0, 19, 36])
def test_hash_no_pad_matches_reference(n):
    rng = np.random.default_rng(n)
    vals = rng.integers(0, P, size=(2, n), dtype=np.uint64)
    if n >= 3:
        vals[0, :3] = [0, 1, P - 1]
    got = gl.join_u64(pgl.hash_no_pad(gl.split_u64(vals)))
    want = junpack(jpgl.hash_no_pad(jpack(vals)))
    assert np.array_equal(got, want)


def test_public_inputs_hash_vector():
    inputs = gl.split_u64(np.array([0, 1, 3736710860384812976], dtype=np.uint64))
    out = gl.join_u64(pgl.hash_no_pad(inputs))
    assert out.tolist() == [8416658900775745054, 12574228347150446423,
                            9629056739760131473, 3119289788404190010]


def _bn_states(n, seed):
    """(n, 4, 16) Montgomery limbs; state 0 holds 0, 1, p-1 (as in
    test_pallas_kernels.py)."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 1 << 62, size=(n, 4)).tolist()
    ints[0][:3] = [0, 1, bn254.P - 1]
    return np.asarray([[bn254.int_to_mont_limbs(v) for v in row] for row in ints],
                      dtype=np.uint32)


def test_poseidon_bn254_plain_matches_permute_jnp():
    st = _bn_states(6, seed=8).reshape(3, 2, 4, 16)
    want = np.asarray(jpb._permute_jnp(jnp.asarray(st)))
    got = kb.permute(torch.as_tensor(st.astype(np.int64)))   # CPU -> plain
    assert got.shape == (3, 2, 4, 16)
    assert np.array_equal(got.numpy().astype(np.uint32), want)


def test_poseidon_bn254_vectors():
    # reference poseidon/bn254_test.go:41-88 (as in test_bn254.py)
    BP = bn254.P
    cases = [
        ([0, 0, 0, 0],
         [5317387130258456662214331362918410991734007599705406860481038345552731150762,
          17768273200467269691696191901389126520069745877826494955630904743826040320364,
          19413739268543925182080121099097652227979760828059217876810647045303340666757,
          3717738800218482999400886888123026296874264026760636028937972004600663725187]),
        ([0, 1, 2, 3],
         [6542985608222806190361240322586112750744169038454362455181422643027100751666,
          3478427836468552423396868478117894008061261013954248157992395910462939736589,
          1904980799580062506738911865015687096398867595589699208837816975692422464009,
          11971464497515232077059236682405357499403220967704831154657374522418385384151]),
        ([BP - 1, BP - 1, BP - 1, BP - 1],
         [13055670547682322550638362580666986963569035646873545133474324633020685301274,
          19087936485076376314486368416882351797015004625427655501762827988254486144933,
          10391468779200270580383536396630001155994223659670674913170907401637624483385,
          17202557688472898583549180366140168198092766974201433936205272956998081177816]),
    ]
    st = torch.tensor([[bn254.int_to_mont_limbs(v) for v in c[0]] for c in cases])
    out = pb.permute(st)
    rinv = pow(bn254.R, -1, BP)
    for (_, want), row in zip(cases, out.tolist()):
        assert [bn254.limbs_to_int(limbs) * rinv % BP for limbs in row] == want


def test_two_to_one_is_permute_of_assembled_state():
    left = torch.tensor([bn254.int_to_mont_limbs(v) for v in (123, 456)])
    right = torch.tensor([bn254.int_to_mont_limbs(v) for v in (789, 1011)])
    out = pb.two_to_one(left, right)
    z = torch.zeros_like(left)
    want = pb.permute(torch.stack([z, z, left, right], dim=-2))[..., 0, :]
    assert out.shape == (2, 16) and torch.equal(out, want)


def test_bn254_wrapper_has_no_fallback_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device launches
    the CUDA kernel or raises (here a meta tensor, which has no kernel)."""
    st = torch.zeros((2, 4, 16), dtype=torch.int64, device="meta")
    with pytest.raises(build.KernelError):
        kb.permute(st)
