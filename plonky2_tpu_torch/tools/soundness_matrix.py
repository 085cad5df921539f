"""Soundness matrix: corrupt every major proof component, one per lane, and
check that the verdict vector rejects exactly the corrupted lanes.

Counterpart of ``tools/soundness_matrix.py``, with the same corruption cases
(``build_cases``) and the same JSON report.  Each corruption is a single
bit-flip or value tweak in the raw proof JSON, so ingestion stays
structurally valid and the reject is cryptographic.  The cases cover every
component the reference's rangeCheck/assert structure guards
(verifier/verifier.go:84-141, fri/fri.go, plonk/plonk.go): openings (each
category), final poly, pow witness, Merkle caps, initial-tree leaves and
siblings, commit-phase step evals and siblings, the circuit digest, and the
public inputs.

    python -m plonky2_tpu_torch.tools.soundness_matrix [--fixture step]
        [--out FILE] [--cpu]

prints one JSON line (one row per lane with the component and its verdict;
lane 0 must be True, every other lane False) and exits 1 on any wrong lane.
It runs on the GPU unless ``--cpu``; the Poseidon-BN254 kernel follows
``PLONKY2_TPU_PB_IMPL``.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

from .. import verifier
from ..proof import serde
from ..proof.fixtures import load_fixture

TESTDATA = Path(__file__).resolve().parents[2] / "testdata"


def build_cases(raw, vraw):
    """[(name, raw_variant, vraw_variant)] -- lane 0 is the valid proof."""
    P = "proof"

    def mut(fn):
        r, v = copy.deepcopy(raw), copy.deepcopy(vraw)
        fn(r, v)
        return r, v

    def flip_dec_str(container, key_or_idx):
        # decimal-string digest -> +-1 (stays in range: digests are random)
        s = container[key_or_idx]
        container[key_or_idx] = str(int(s) ^ 1)

    cases = [("valid", raw, vraw)]

    for opening in ["constants", "plonk_sigmas", "wires", "plonk_zs",
                    "plonk_zs_next", "partial_products", "quotient_polys"]:
        cases.append((f"openings.{opening}", *mut(
            lambda r, v, o=opening: r[P]["openings"].__setitem__(
                o, [[r[P]["openings"][o][0][0] ^ 1,
                     r[P]["openings"][o][0][1]]] + r[P]["openings"][o][1:]))))

    cases.append(("final_poly", *mut(
        lambda r, v: r[P]["opening_proof"]["final_poly"]["coeffs"][0].__setitem__(
            0, r[P]["opening_proof"]["final_poly"]["coeffs"][0][0] ^ 1))))
    cases.append(("pow_witness", *mut(
        lambda r, v: r[P]["opening_proof"].__setitem__(
            "pow_witness", r[P]["opening_proof"]["pow_witness"] ^ 1))))

    cases.append(("wires_cap", *mut(
        lambda r, v: flip_dec_str(r[P]["wires_cap"], 0))))
    cases.append(("zs_partial_products_cap", *mut(
        lambda r, v: flip_dec_str(r[P]["plonk_zs_partial_products_cap"], 3))))
    cases.append(("quotient_polys_cap", *mut(
        lambda r, v: flip_dec_str(r[P]["quotient_polys_cap"], 1))))
    cases.append(("commit_phase_cap", *mut(
        lambda r, v: flip_dec_str(
            r[P]["opening_proof"]["commit_phase_merkle_caps"][0], 2))))

    def qr(r):
        return r[P]["opening_proof"]["query_round_proofs"]

    cases.append(("initial_tree_leaf", *mut(
        lambda r, v: qr(r)[5]["initial_trees_proof"]["evals_proofs"][1][0]
        .__setitem__(3, qr(r)[5]["initial_trees_proof"]["evals_proofs"][1][0][3] ^ 1))))
    cases.append(("initial_tree_sibling", *mut(
        lambda r, v: flip_dec_str(
            qr(r)[2]["initial_trees_proof"]["evals_proofs"][0][1]["siblings"],
            4))))
    cases.append(("step_evals", *mut(
        lambda r, v: qr(r)[7]["steps"][0]["evals"][3].__setitem__(
            0, qr(r)[7]["steps"][0]["evals"][3][0] ^ 1))))
    cases.append(("step_sibling", *mut(
        lambda r, v: flip_dec_str(
            qr(r)[1]["steps"][1]["merkle_proof"]["siblings"], 0))))

    cases.append(("circuit_digest", *mut(
        lambda r, v: flip_dec_str(v, "circuit_digest"))))
    cases.append(("constants_sigmas_cap", *mut(
        lambda r, v: flip_dec_str(v["constants_sigmas_cap"], 0))))

    if raw["public_inputs"]:
        cases.append(("public_inputs", *mut(
            lambda r, v: r["public_inputs"].__setitem__(
                0, r["public_inputs"][0] ^ 1))))
    return cases


def run(fixture, device="cuda"):
    """Verify the matrix of ``testdata/<fixture>`` in one batch on
    ``device``; returns the report dict (``all_correct`` and one row per
    lane)."""
    device = verifier.resolve_device(device)
    spec, raw, vraw = load_fixture(TESTDATA / fixture)
    cases = build_cases(raw, vraw)
    batch, mask, errors = serde.ingest_batch(
        spec, [(r, v) for _, r, v in cases])
    if not mask.all():
        raise serde.InvalidProofError(
            f"corruptions must stay structurally valid: {errors}")
    verdicts = verifier.verify_batch(spec, batch, device=device)
    rows = [{"component": name, "verdict": bool(b)}
            for (name, _, _), b in zip(cases, verdicts)]
    expected = [i == 0 for i in range(len(cases))]
    return {
        "metric": "soundness_matrix",
        "fixture": fixture,
        "device": verifier.device_name(device),
        "lanes": len(cases),
        "all_correct": verdicts.tolist() == expected,
        "rows": rows,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plonky2_tpu_torch.tools.soundness_matrix")
    ap.add_argument("--fixture", default="step")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    try:
        device = verifier.resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        print(f"soundness_matrix: {e}; pass --cpu", file=sys.stderr)
        return 2
    out = run(args.fixture, device)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if not out["all_correct"]:
        bad = [r for i, r in enumerate(out["rows"]) if r["verdict"] != (i == 0)]
        print(f"# MISMATCH: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
