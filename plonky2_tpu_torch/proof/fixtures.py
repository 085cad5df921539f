"""Loading the reference proof fixtures and producing corrupted variants
(counterpart of ``plonky2_tpu/proof/fixtures.py``; used by chip_smoke.py and
the tests -- one source of truth for the fixture paths and the corruption
sites).  Every corruption is made on the raw JSON, so any verifier that reads
the JSON sees the same input."""

from __future__ import annotations

import copy
import json
import os

from ..fields.goldilocks import P
from .spec import load_circuit_spec


def load_fixture(circuit_dir):
    """testdata dir -> (spec, raw_proof_json, verifier_only_json)."""
    spec = load_circuit_spec(
        os.path.join(circuit_dir, "common_circuit_data.json"))
    with open(os.path.join(circuit_dir, "proof_with_public_inputs.json")) as f:
        raw = json.load(f)
    with open(os.path.join(circuit_dir,
                           "verifier_only_circuit_data.json")) as f:
        vraw = json.load(f)
    return spec, raw, vraw


def corrupt_wires_opening(raw):
    """Deep-copied proof JSON with one bit flipped in openings.wires[0][0]
    -- the canonical 'cryptographically invalid, structurally fine'
    corruption used across bench and tests."""
    bad = copy.deepcopy(raw)
    bad["proof"]["openings"]["wires"][0][0] ^= 1
    return bad


def corrupt_leaf(raw, query_round=0):
    """Deep-copied proof JSON with 1 added (mod p, so it stays canonical) to
    one element of a query round's initial-tree leaf for oracle 1 (round 0
    by default; -1 is the last): a Merkle failure that leaves the transcript
    before the FRI queries untouched and that only that round's check sees."""
    bad = copy.deepcopy(raw)
    qr = bad["proof"]["opening_proof"]["query_round_proofs"][query_round]
    leaf = qr["initial_trees_proof"]["evals_proofs"][1][0]
    leaf[5] = (int(leaf[5]) + 1) % P
    return bad


def corrupt_pow_witness(raw):
    """Deep-copied proof JSON with the FRI proof-of-work witness changed."""
    bad = copy.deepcopy(raw)
    op = bad["proof"]["opening_proof"]
    op["pow_witness"] = (int(op["pow_witness"]) + 1) % P
    return bad


def decode_block_lanes(circuit_dir="testdata/decode_block"):
    """(spec, [valid, bad opening, bad leaf, bad pow] proof JSONs,
    verifier-only JSON): the batch whose verdict is [T, F, F, F]."""
    spec, raw, vraw = load_fixture(circuit_dir)
    raws = [raw, corrupt_wires_opening(raw), corrupt_leaf(raw),
            corrupt_pow_witness(raw)]
    return spec, raws, vraw


def drop_wires_opening(raw):
    """Deep-copied proof JSON with the last wire opening removed: it fails
    ingest, so ``serde.ingest_batch`` quarantines its lane."""
    bad = copy.deepcopy(raw)
    bad["proof"]["openings"]["wires"] = bad["proof"]["openings"]["wires"][:-1]
    return bad


def query_shard_lanes(circuit_dir="testdata/decode_block"):
    """(spec, [valid, bad opening, a leaf corrupted in the last query round,
    a proof that fails ingest] JSONs, verifier-only JSON): with the query
    rounds split in two, only the last query shard can reject lane 2 and
    only the ingest mask lane 3; the verdict is [T, F, F, F]."""
    spec, raw, vraw = load_fixture(circuit_dir)
    raws = [raw, corrupt_wires_opening(raw), corrupt_leaf(raw, query_round=-1),
            drop_wires_opening(raw)]
    return spec, raws, vraw
