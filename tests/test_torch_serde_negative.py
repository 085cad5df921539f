"""The JAX package's negative-ingest cases (``tests/test_serde_negative.py``)
held against the port: every structurally invalid proof that the JAX
``serde.ingest_proof`` rejects, the port rejects with ``InvalidProofError``
and the same message; the HashOrNoop packing, the noop flags and the
non-canonical-index check agree; and the port's FRI proof-of-work check
``_pow_ok`` gives the JAX function's verdict in each of its four branches
(64 - pow_bits below, at, above 32 and 64).  Host numpy and integers only:
every comparison is exact."""
import copy
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

from plonky2_tpu.fri.verify import _pow_ok as jpow_ok
from plonky2_tpu.proof import serde as jserde
from plonky2_tpu.proof.spec import load_circuit_spec as jload_spec
from plonky2_tpu.proof.synthetic import make_tiny_spec as jmake_tiny_spec
from plonky2_tpu_torch.fields import bn254
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.fri.verify import _pow_ok
from plonky2_tpu_torch.proof import serde
from plonky2_tpu_torch.proof.spec import load_circuit_spec
from plonky2_tpu_torch.proof.synthetic import make_tiny_spec

FIX = "testdata/decode_block"


@pytest.fixture(scope="module")
def specs():
    path = f"{FIX}/common_circuit_data.json"
    return jload_spec(path), load_circuit_spec(path)


@pytest.fixture(scope="module")
def raw():
    with open(f"{FIX}/proof_with_public_inputs.json") as f:
        proof = json.load(f)
    with open(f"{FIX}/verifier_only_circuit_data.json") as f:
        vdata = json.load(f)
    return proof, vdata


def _round0(proof):
    return proof["proof"]["opening_proof"]["query_round_proofs"][0]


def _evals_proof(proof, oracle):
    return _round0(proof)["initial_trees_proof"]["evals_proofs"][oracle]


def noncanonical_opening(proof, vdata):
    proof["proof"]["openings"]["wires"][0][0] = gl.P


def noncanonical_leaf(proof, vdata):
    _evals_proof(proof, 0)[0][0] = gl.P + 5


def noncanonical_pow_witness(proof, vdata):
    proof["proof"]["opening_proof"]["pow_witness"] = gl.P


def digest_out_of_range(proof, vdata):
    proof["proof"]["wires_cap"][0] = str(bn254.P)


def sibling_out_of_range(proof, vdata):
    _evals_proof(proof, 0)[1]["siblings"][0] = str(bn254.P + 1)


def wrong_cap_size(proof, vdata):
    proof["proof"]["wires_cap"] = proof["proof"]["wires_cap"][:-1]


def wrong_query_round_count(proof, vdata):
    op = proof["proof"]["opening_proof"]
    op["query_round_proofs"] = op["query_round_proofs"][:-1]


def truncated_openings(proof, vdata):
    proof["proof"]["openings"]["wires"] = \
        proof["proof"]["openings"]["wires"][:-1]


def final_poly_length(proof, vdata):
    fp = proof["proof"]["opening_proof"]["final_poly"]
    fp["coeffs"] = fp["coeffs"] + [[0, 0]]


def wrong_merkle_depth(proof, vdata):
    mp = _evals_proof(proof, 1)[1]
    mp["siblings"] = mp["siblings"][:-1]


def wrong_leaf_size(proof, vdata):
    ep = _evals_proof(proof, 3)
    ep[0] = ep[0][:-1]


def wrong_step_evals(proof, vdata):
    st = _round0(proof)["steps"][0]
    st["evals"] = st["evals"][:-1]


def wrong_vdata_cap(proof, vdata):
    vdata["constants_sigmas_cap"] = vdata["constants_sigmas_cap"][:-1]


# (mutation, the JAX test's pattern), one a test of test_serde_negative.py
REJECTS = [(noncanonical_opening, "non-canonical"),
           (noncanonical_leaf, "non-canonical"),
           (noncanonical_pow_witness, "non-canonical"),
           (digest_out_of_range, "out of range"),
           (sibling_out_of_range, "out of range"),
           (wrong_cap_size, "size mismatch"),
           (wrong_query_round_count, "query rounds"),
           (truncated_openings, "length mismatch"),
           (final_poly_length, "final poly"),
           (wrong_merkle_depth, "depth mismatch"),
           (wrong_leaf_size, "leaf size"),
           (wrong_step_evals, "step evals"),
           (wrong_vdata_cap, "size mismatch")]


def test_fixture_ingests_clean_in_both(specs, raw):
    want = jserde.ingest_proof(specs[0], *copy.deepcopy(raw))
    got = serde.ingest_proof(specs[1], *copy.deepcopy(raw))
    assert got["pow_witness"].dtype == want["pow_witness"].dtype == np.uint64
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("mutate,match", REJECTS,
                         ids=[m.__name__ for m, _ in REJECTS])
def test_reject_matches_jax(specs, raw, mutate, match):
    proof, vdata = copy.deepcopy(raw)
    mutate(proof, vdata)
    with pytest.raises(jserde.InvalidProofError, match=match) as want:
        jserde.ingest_proof(specs[0], proof, vdata)
    with pytest.raises(serde.InvalidProofError, match=match) as got:
        serde.ingest_proof(specs[1], proof, vdata)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("vals", [[123456789, 987654321, 5], [42], [7, 8],
                                  [1, 2, 3, 4], list(range(1, 11))])
def test_hash_or_noop_packing_matches_jax(vals):
    """A leaf of 3 elements or fewer packs to one block, sum v_k 2^(64 k),
    with the slot mask [True, False, False]; longer leaves pack as the JAX
    package packs them."""
    got, want = serde._pack_leaf_mont(vals), jserde._pack_leaf_mont(vals)
    assert len(got) == len(want)
    for (block, mask), (jblock, jmask) in zip(got, want):
        assert np.array_equal(np.asarray(block), np.asarray(jblock))
        assert np.array_equal(np.asarray(mask), np.asarray(jmask))
    if len(vals) <= 3:
        packed = sum(v << (64 * k) for k, v in enumerate(vals))
        assert list(got[0][0][0]) == bn254.int_to_mont_limbs(packed)
        assert list(got[0][1]) == [True, False, False]


def test_leaf_layout_noop_flags_match_jax(specs):
    for spec, jspec in ((make_tiny_spec(), jmake_tiny_spec()),
                        (specs[1], specs[0])):
        layout = serde.leaf_layout(spec)
        assert np.array_equal(layout.noop, jserde.leaf_layout(jspec).noop)
        for o, size in enumerate(spec.oracle_leaf_sizes):
            assert layout.noop[o] == (size <= 3)


def test_noncanonical_indices_check_matches_jax():
    """Rate 2^-3 passes; rate 2^-50 raises ValueError, with the JAX
    package's message."""
    make_tiny_spec().assert_noncanonical_indices_ok()
    jmake_tiny_spec().assert_noncanonical_indices_ok()
    bad = dataclasses.replace(make_tiny_spec(), rate_bits=50)
    jbad = dataclasses.replace(jmake_tiny_spec(), rate_bits=50)
    with pytest.raises(ValueError, match="non-canonical") as want:
        jbad.assert_noncanonical_indices_ok()
    with pytest.raises(ValueError, match="non-canonical") as got:
        bad.assert_noncanonical_indices_ok()
    assert str(got.value) == str(want.value)


# (pow response, pow_bits, verdict): the JAX test's values, in the branches
# 64 - pow_bits = 24 (< 32), 32, 48 (the fixtures' pow_bits = 16) and 64
POW_CASES = [((1 << 24) - 1, 40, True), (1 << 24, 40, False),
             (1 << 35, 40, False), ((1 << 32) - 1, 32, True),
             (1 << 32, 32, False), ((1 << 48) - 1, 16, True),
             (1 << 48, 16, False), (123, 16, True),
             ((1 << 63) + 5, 0, True)]


@pytest.mark.parametrize("value,pow_bits,want", POW_CASES)
def test_pow_ok_matches_jax(value, pow_bits, want):
    pr = gl.split_u64(np.array([value], np.uint64))
    jpr = (jnp.asarray([value & 0xFFFFFFFF], jnp.uint32),
           jnp.asarray([value >> 32], jnp.uint32))
    assert _pow_ok(pr, pow_bits).tolist() == [want]
    assert np.asarray(jpow_ok(jpr, pow_bits)).tolist() == [want]
