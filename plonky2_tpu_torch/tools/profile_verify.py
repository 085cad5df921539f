"""Stage times of the verifier on one batch.

Counterpart of ``tools/profile_verify.py``: times the stages of
``verifier.verify_device`` one by one on the same batch, with a
``torch.cuda.synchronize()`` after each (``utils.profiling.StageTimer``), so
optimisation effort lands where the time goes:

    prepare     observed sequence, tensors, host -> device
    pi_hash     public-input hash (Poseidon-GL sponge)
    transcript  Fiat-Shamir scan (the transcript kernel on the GPU)
    challenges  challenge reads from the transcript states
    plonk       PLONK vanishing check
    fri         FRI opening check (Poseidon-BN254 kernel for every Merkle hash)
    verdict     device -> host copy of the (B,) verdicts

    python -m plonky2_tpu_torch.tools.profile_verify [--circuit testdata/step]
        [--batch 256] [--reps 3] [--cpu]

prints one JSON line per repetition; it runs on the GPU unless ``--cpu``.
The Poseidon-BN254 kernel follows ``PLONKY2_TPU_PB_IMPL``.
"""

from __future__ import annotations

import argparse
import json
import sys

from .. import verifier
from ..proof import serde
from ..proof.fixtures import load_fixture
from ..utils.profiling import StageTimer


def profile_stages(spec, batch, device):
    """Seconds per stage of one verification of ``batch``, plus ``total``
    and the verdicts (a (B,) bool numpy array, quarantined lanes False as in
    ``verifier.verify_batch``) under ``verdicts``."""
    device = verifier.resolve_device(device)
    timer = StageTimer(device)
    with timer.stage("prepare"):
        schedule, dev, obs = verifier.prepare(spec, batch, device)
    verdict = verifier.verify_device(spec, schedule, dev, obs, timer=timer)
    with timer.stage("verdict"):
        verdicts = verifier.apply_valid_masks(verdict.cpu().numpy(), batch)
    out = dict(timer.timings)
    out["total"] = sum(out.values())
    out["verdicts"] = verdicts
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plonky2_tpu_torch.tools.profile_verify")
    ap.add_argument("--circuit", default="testdata/step")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    try:
        device = verifier.resolve_device(device)
    except RuntimeError as e:
        print(f"profile_verify: {e}; pass --cpu", file=sys.stderr)
        return 2

    spec, raw, vraw = load_fixture(args.circuit)
    batch = serde.stack_proofs([serde.ingest_proof(spec, raw, vraw)] * args.batch)
    for rep in range(args.reps):
        st = profile_stages(spec, batch, device)
        ok = bool(st.pop("verdicts").all())
        print(json.dumps({"circuit": args.circuit, "batch": args.batch,
                          "rep": rep, "device": verifier.device_name(device),
                          "all_valid": ok, "seconds": st}))
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
