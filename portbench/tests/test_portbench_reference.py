"""The frozen plain reference: its verdicts on the fixtures and its
constant tables against the JAX package's (read as source, not
imported)."""

import ast
import copy
import json

import pytest

from portbench.harness import catalog
from portbench.reference import bn254_constants, gl_constants, plain_verifier

CIRCUITS = catalog.BENCH_DIR / "circuits"


def _fixture(name):
    d = CIRCUITS / name
    spec = plain_verifier.load_spec(d / "common_circuit_data.json")
    raw = json.loads((d / "proof_with_public_inputs.json").read_text())
    vraw = json.loads((d / "verifier_only_circuit_data.json").read_text())
    return spec, raw, vraw


def _bad_opening(raw):
    bad = copy.deepcopy(raw)
    bad["proof"]["openings"]["wires"][0][0] ^= 1
    return bad


def _bad_leaf(raw):
    bad = copy.deepcopy(raw)
    leaf = bad["proof"]["opening_proof"]["query_round_proofs"][0][
        "initial_trees_proof"]["evals_proofs"][1][0]
    leaf[5] = (int(leaf[5]) + 1) % plain_verifier.P
    return bad


def _bad_pow(raw):
    bad = copy.deepcopy(raw)
    op = bad["proof"]["opening_proof"]
    op["pow_witness"] = (int(op["pow_witness"]) + 1) % plain_verifier.P
    return bad


def test_decode_block_lanes():
    """[valid, bad opening, bad leaf, bad pow] reads [T, F, F, F], the
    fixtures' known verdicts, with PLONK and FRI apart."""
    spec, raw, vraw = _fixture("decode_block")
    got = [plain_verifier.verify(spec, r, vraw)
           for r in (raw, _bad_opening(raw), _bad_leaf(raw), _bad_pow(raw))]
    assert [g["verdict"] for g in got] == [True, False, False, False]
    assert [g["plonk_ok"] for g in got] == [True, False, True, True]
    assert [g["fri_ok"] for g in got] == [True, False, False, False]


def test_step_valid_and_invalid():
    spec, raw, vraw = _fixture("step")
    assert plain_verifier.verify(spec, raw, vraw)["verdict"] is True
    bad = copy.deepcopy(raw)
    bad["public_inputs"][0] = (int(bad["public_inputs"][0]) + 1) \
        % plain_verifier.P
    assert plain_verifier.verify(spec, bad, vraw) == {
        "verdict": False, "plonk_ok": False, "fri_ok": False}


def test_first_round_control_misses_a_later_round():
    """The control that checks one query round passes a leaf corrupted in
    round 1 that the reference rejects."""
    spec, raw, vraw = _fixture("decode_block")
    bad = copy.deepcopy(raw)
    leaf = bad["proof"]["opening_proof"]["query_round_proofs"][1][
        "initial_trees_proof"]["evals_proofs"][2][0]
    leaf[0] = (int(leaf[0]) + 1) % plain_verifier.P
    assert plain_verifier.verify(spec, bad, vraw)["fri_ok"] is False
    assert plain_verifier.verify(spec, bad, vraw, query_rounds=1)["fri_ok"]


def _tables(path):
    tree = ast.parse(path.read_text())
    return {node.targets[0].id: ast.literal_eval(node.value)
            for node in tree.body if isinstance(node, ast.Assign)}


@pytest.mark.parametrize("frozen, original", [
    (gl_constants, "poseidon_gl_constants.py"),
    (bn254_constants, "poseidon_bn254_constants.py")])
def test_tables_equal_the_jax_packages(frozen, original):
    """Value for value the JAX package's tables that the reference reads."""
    jax_tables = _tables(catalog.ROOT / "plonky2_tpu" / "hash" / original)
    names = [n for n in dir(frozen) if n.isupper()]
    assert names
    for name in names:
        assert getattr(frozen, name) == jax_tables[name], name
