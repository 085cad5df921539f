"""Ingest parity: the port's serde returns arrays identical to the JAX
package's (values, dtypes and shapes), and quarantines the same malformed
proofs with the same messages.  Comparisons are exact: ingest is integer
bookkeeping, so no tolerance applies."""
import copy
import json

import numpy as np
import pytest

from plonky2_tpu.proof import serde as jserde
from plonky2_tpu.proof.spec import load_circuit_spec as jload_spec
from plonky2_tpu_torch.proof import serde
from plonky2_tpu_torch.proof.spec import load_circuit_spec

FIXTURES = ["step", "decode_block"]


def _raw(name):
    with open(f"testdata/{name}/proof_with_public_inputs.json") as f:
        raw = json.load(f)
    with open(f"testdata/{name}/verifier_only_circuit_data.json") as f:
        vraw = json.load(f)
    return raw, vraw


@pytest.mark.parametrize("name", FIXTURES)
def test_spec_and_ingest_match_reference(name):
    path = f"testdata/{name}/common_circuit_data.json"
    jspec, spec = jload_spec(path), load_circuit_spec(path)
    assert [type(g).__name__ for g in spec.gates()] == \
        [type(g).__name__ for g in jspec.gates()]
    for field in ("degree_bits", "num_query_rounds", "reduction_arity_bits",
                  "oracle_leaf_sizes", "step_tree_depths", "gate_ids"):
        assert getattr(spec, field) == getattr(jspec, field), field

    jl, pl = jserde.leaf_layout(jspec), serde.leaf_layout(spec)
    assert jl.n_steps == pl.n_steps and jl.max_steps == pl.max_steps
    assert np.array_equal(jl.slot_mask, pl.slot_mask)
    assert np.array_equal(jl.noop, pl.noop)

    raw, vraw = _raw(name)
    want = jserde.ingest_proof(jspec, raw, vraw)
    got = serde.ingest_proof(spec, raw, vraw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_ingest_batch_quarantines_like_reference():
    spec = load_circuit_spec("testdata/decode_block/common_circuit_data.json")
    jspec = jload_spec("testdata/decode_block/common_circuit_data.json")
    raw, vraw = _raw("decode_block")
    bad_shape = copy.deepcopy(raw)          # truncated openings
    bad_shape["proof"]["openings"]["wires"] = \
        bad_shape["proof"]["openings"]["wires"][:-1]
    bad_range = copy.deepcopy(raw)          # non-canonical GL element (= p)
    bad_range["proof"]["openings"]["wires"][0][0] = 18446744069414584321
    bad_missing = copy.deepcopy(raw)        # missing field -> KeyError
    del bad_missing["proof"]["openings"]["wires"]
    bad_ragged = copy.deepcopy(raw)         # ragged array -> ValueError
    bad_ragged["proof"]["openings"]["wires"][0] = \
        bad_ragged["proof"]["openings"]["wires"][0][:1]
    pairs = [(raw, vraw), (bad_shape, vraw), (bad_range, vraw),
             (bad_missing, vraw), (bad_ragged, vraw)]

    batch, mask, errors = serde.ingest_batch(spec, pairs)
    jbatch, jmask, jerrors = jserde.ingest_batch(jspec, pairs)
    assert mask.tolist() == jmask.tolist() == [True, False, False, False, False]
    assert errors == jerrors
    assert "length mismatch" in errors[1]
    assert "non-canonical" in errors[2]
    assert "KeyError" in errors[3]
    for k in jbatch:
        assert np.array_equal(batch[k], jbatch[k]), k

    with pytest.raises(serde.InvalidProofError):
        serde.ingest_batch(spec, [(bad_shape, vraw)])
