"""Transcript parity: the port's schedule and observed sequence equal the
JAX package's, its plain transcript scan (the CPU path of the CUDA kernel's
wrapper) equals ``challenger._run_transcript_jnp`` on the decode_block
schedule, and the full port path reproduces the pinned decode_block
challenges of test_transcript.py.  All values are integers, compared
exactly: no tolerance applies."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plonky2_tpu.proof import serde as jserde
from plonky2_tpu.proof.spec import load_circuit_spec as jload_spec
from plonky2_tpu.transcript import challenger as jchal
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.hash import poseidon_gl as pgl
from plonky2_tpu_torch.kernels import build
from plonky2_tpu_torch.proof import serde
from plonky2_tpu_torch.proof.spec import load_circuit_spec
from plonky2_tpu_torch.transcript import challenger as chal

torch.set_num_threads(1)
SPEC = "testdata/decode_block/common_circuit_data.json"


def jsplit(arr):
    arr = np.asarray(arr, dtype=np.uint64)
    return (jnp.asarray((arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((arr >> np.uint64(32)).astype(np.uint32)))


def test_schedule_and_observed_sequence_match_reference():
    spec, jspec = load_circuit_spec(SPEC), jload_spec(SPEC)
    s, js = chal.build_schedule(spec), jchal.build_schedule(jspec)
    assert (s.n_obs, s.n_perms, s.pi_hash_offset) == \
        (js.n_obs, js.n_perms, js.pi_hash_offset)
    assert np.array_equal(s.gather_idx, js.gather_idx)
    assert np.array_equal(s.mask, js.mask)
    for f in ("plonk_betas", "plonk_gammas", "plonk_alphas", "plonk_zeta",
              "fri_alpha", "fri_betas", "fri_pow_response", "fri_query_indices"):
        assert getattr(s, f) == getattr(js, f), f
    proof = serde.stack_proofs([serde.load_proof(
        spec, "testdata/decode_block/proof_with_public_inputs.json",
        "testdata/decode_block/verifier_only_circuit_data.json")])
    assert np.array_equal(chal.build_observed_host(spec, proof),
                          jchal.build_observed_host(jspec, proof))


def test_plain_scan_matches_run_transcript_jnp():
    """B=2 random observed sequences on the decode_block schedule, as in
    test_pallas_kernels.py::test_transcript_kernel_matches_jnp_scan."""
    spec = load_circuit_spec(SPEC)
    schedule = chal.build_schedule(spec)
    rng = np.random.default_rng(3)
    obs = rng.integers(0, gl.P, size=(2, schedule.n_obs), dtype=np.uint64)
    obs[0, :3] = [0, 1, gl.P - 1]
    pi = rng.integers(0, gl.P, size=(2, 4), dtype=np.uint64)

    got = chal.run_transcript(schedule, gl.split_u64(obs), gl.split_u64(pi))
    want = jchal._run_transcript_jnp(jchal.build_schedule(jload_spec(SPEC)),
                                     jsplit(obs), jsplit(pi))
    assert got[0].shape == (schedule.n_perms, 2, 12)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]).astype(np.int64))


def test_decode_block_transcript_vectors():
    spec = load_circuit_spec(SPEC)
    batch = serde.stack_proofs([serde.load_proof(
        spec, "testdata/decode_block/proof_with_public_inputs.json",
        "testdata/decode_block/verifier_only_circuit_data.json")])
    schedule = chal.build_schedule(spec)
    obs = gl.split_u64(chal.build_observed_host(spec, batch))
    pi_hash = pgl.hash_no_pad(gl.split_u64(batch["public_inputs"]))
    states = chal.run_transcript(schedule, obs, pi_hash)

    def rd(pos):
        return int(gl.join_u64(chal.read_challenge(states, pos))[0])

    assert rd(schedule.plonk_betas[0]) == 17615363392879944733
    assert rd(schedule.plonk_gammas[0]) == 15174493176564484303
    assert rd(schedule.plonk_alphas[0]) == 9276470834414745550
    assert rd(schedule.plonk_zeta[0]) == 3892795992421241388
    assert rd(schedule.fri_alpha[0]) == 885535811531859621
    assert rd(schedule.fri_betas[0][0]) == 5231781384587895507
    assert rd(schedule.fri_pow_response) == 70715523064019
    assert rd(schedule.fri_query_indices[0]) == 11890500485816111017


def test_transcript_wrapper_has_no_fallback_off_the_cpu():
    """Only CPU tensors take the plain scan: any other device launches the
    CUDA kernel or raises (here meta tensors, which have no kernel)."""
    schedule = chal.build_schedule(load_circuit_spec(SPEC))
    obs = gl.zeros((2, schedule.n_obs), "meta")
    with pytest.raises(build.KernelError):
        chal.run_transcript(schedule, obs, gl.zeros((2, 4), "meta"))
