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


def corrupt_leaf(raw):
    """Deep-copied proof JSON with 1 added (mod p, so it stays canonical) to
    one element of query round 0's initial-tree leaf for oracle 1: a Merkle
    failure that leaves the transcript before the FRI queries untouched."""
    bad = copy.deepcopy(raw)
    qr0 = bad["proof"]["opening_proof"]["query_round_proofs"][0]
    leaf = qr0["initial_trees_proof"]["evals_proofs"][1][0]
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
