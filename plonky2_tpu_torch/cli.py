"""Command line of the PyTorch + CUDA verifier.

Counterpart of ``plonky2_tpu/cli.py`` (the reference's benchmark.go analog):

    python -m plonky2_tpu_torch.cli verify  --circuit testdata/step [--batch N]
    python -m plonky2_tpu_torch.cli bench   --circuit testdata/step [--batch N]
                                            [--iters K]
    python -m plonky2_tpu_torch.cli inspect --circuit testdata/step
    python -m plonky2_tpu_torch.cli ... --profile DIR  (torch.profiler trace)
    python -m plonky2_tpu_torch.cli ... --cpu          (run on the CPU)
    python -m plonky2_tpu_torch.cli ... --out FILE     (also save the report)

``verify`` and ``bench`` run on the GPU unless ``--cpu`` is given; without a
GPU they exit non-zero.  ``bench`` times ``verifier.verify_device`` on
tensors already on the device, each call ended by ``torch.cuda.synchronize``;
its first call, which pays one-time costs (kernel build and load, constant
tables), is reported as ``first_call_s`` where the JAX CLI reports
``compile_s``.  ``inspect`` prints the static cost model.  The
Poseidon-BN254 kernel follows ``PLONKY2_TPU_PB_IMPL`` (``mxu`` or ``cios``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch

from . import verifier
from .proof import serde
from .proof.spec import load_circuit_spec
from .utils.profiling import StageTimer, flops_report, trace


def _load(circuit_dir):
    spec = load_circuit_spec(
        os.path.join(circuit_dir, "common_circuit_data.json"))
    proof = serde.load_proof(
        spec,
        os.path.join(circuit_dir, "proof_with_public_inputs.json"),
        os.path.join(circuit_dir, "verifier_only_circuit_data.json"))
    return spec, proof


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_verify(args, device):
    spec, proof = _load(args.circuit)
    timer = StageTimer(device)
    with timer.stage("ingest"):
        batch = serde.stack_proofs([proof] * args.batch)
    with timer.stage("verify"):
        verdicts = verifier.verify_batch(spec, batch, device=device)
    ok = bool(verdicts.all())
    report = timer.report(
        circuit=args.circuit, batch=args.batch,
        device=verifier.device_name(device), all_valid=ok,
        verdicts=verdicts.astype(int).tolist())
    print(report)
    _maybe_save(args, report)
    return 0 if ok else 1


def cmd_bench(args, device):
    spec, proof = _load(args.circuit)
    batch = serde.stack_proofs([proof] * args.batch)
    schedule, dev, obs = verifier.prepare(spec, batch, device)

    def run():
        out = verifier.verify_device(spec, schedule, dev, obs)
        _sync(device)
        return out

    t0 = time.perf_counter()
    out = run()
    first_call_s = time.perf_counter() - t0
    if not bool(out.all()):
        print("bench: the fixture proof did not verify", file=sys.stderr)
        return 1

    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    best = min(times)
    report = json.dumps({
        "circuit": args.circuit, "batch": args.batch,
        "device": verifier.device_name(device),
        "first_call_s": round(first_call_s, 3),
        "steady_state_s": round(best, 6),
        "proofs_per_sec": round(args.batch / best, 2)})
    print(report)
    _maybe_save(args, report)
    return 0


def _maybe_save(args, report_json_line):
    if args.out:
        with open(args.out, "w") as f:
            f.write(report_json_line.rstrip() + "\n")


def cmd_inspect(args, device):
    spec = load_circuit_spec(
        os.path.join(args.circuit, "common_circuit_data.json"))
    report = flops_report(spec)
    report["gates"] = list(spec.gate_ids)
    print(json.dumps(report, indent=2))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plonky2_tpu_torch")
    ap.add_argument("command", choices=["verify", "bench", "inspect"])
    ap.add_argument("--circuit", default="testdata/step",
                    help="dir with common_circuit_data.json / proof / vk")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace to DIR")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the JSON report to FILE")
    args = ap.parse_args(argv)

    cmds = {"verify": cmd_verify, "bench": cmd_bench, "inspect": cmd_inspect}
    device = None
    if args.command != "inspect":
        try:
            device = verifier.resolve_device("cpu" if args.cpu else "cuda")
        except RuntimeError as e:
            print(f"plonky2_tpu_torch: {e}; pass --cpu", file=sys.stderr)
            return 2
    if args.profile and args.command != "inspect":
        ctx = trace(args.profile)
    else:
        ctx = contextlib.nullcontext()
    with ctx:
        return cmds[args.command](args, device)


if __name__ == "__main__":
    sys.exit(main())
