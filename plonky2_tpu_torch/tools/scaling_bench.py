"""Scaling harness: verified proofs/s at mesh size 1 against N, and over N
processes.

Counterpart of ``tools/scaling_bench.py``.  Weak scaling: B proofs per
device, so a mesh of n devices verifies n*B proofs a call.

- Mesh points (``--sizes``): ``parallel/mesh.verify_batch_sharded`` in this
  process over the first n GPUs; one thread issues every shard's work.
- Process points (``--processes``): n ranks of ``parallel/distributed.py``,
  one process per GPU (NCCL), started by ``tools/dist_worker.launch``;
  rank 0's time counts.

Each point verifies the step fixture with global lane 1 corrupted (that lane
alone must be False) and reports the best of ``--iters`` timed calls after
one untimed call, proofs/s and the efficiency against size 1 (proofs/s
over n times size 1's; null without a size-1 point).  A size above
the machine's GPU count is recorded as "not measured", with no number.

    python -m plonky2_tpu_torch.tools.scaling_bench [--sizes 1,2,4,8]
        [--processes 1,2] [--batch 256] [--iters 3] [--out FILE]
        [--cpu [--tiny]]

``--cpu`` runs the same on CPU devices (a mesh names the CPU n times; ranks
use gloo) and ``--tiny`` takes dummy proofs of the tiny spec (all invalid),
for the tests: a CPU point measures the harness, not a device.  Prints one
JSON line and writes it to ``--out`` only when given; exit 2 without a GPU
and without ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import verifier
from ..parallel import mesh as pmesh
from . import dist_worker

STEP = "testdata/step"
CORRUPT_LANE = 1
RANKS_TIMEOUT_S = 900  # a process point: start-up, ingest, iters + 1 calls


def _expected(args, total):
    """The verdicts of ``total`` lanes: dummy proofs are all invalid; of the
    step copies only the corrupted lane is."""
    if args.tiny:
        return np.zeros(total, bool)
    expected = np.ones(total, bool)
    expected[CORRUPT_LANE] = False
    return expected


def _batch(args, n_devices):
    """(spec, batch of n_devices * B lanes, expected verdicts), the lanes
    that n ranks of B proofs verify."""
    circuit = dist_worker.load_circuit("tiny" if args.tiny else STEP)
    total = n_devices * args.batch
    corrupt = () if args.tiny else (CORRUPT_LANE,)
    return (circuit[0], dist_worker.make_lanes(circuit, 0, total, corrupt),
            _expected(args, total))


def _point(n, seconds, batch):
    best = min(seconds)
    return {"n": n, "global_batch": n * batch, "seconds": seconds,
            "best_s": best, "proofs_per_s": n * batch / best}


def measure_mesh(args, n, devices):
    spec, batch, expected = _batch(args, n)
    mesh = pmesh.make_mesh(devices[:n])
    seconds = []
    for it in range(args.iters + 1):
        t0 = time.perf_counter()
        got = pmesh.verify_batch_sharded(spec, batch, mesh)
        if it:
            seconds.append(time.perf_counter() - t0)
        if not np.array_equal(got, expected):
            raise AssertionError(f"mesh size {n}: wrong verdicts in lanes "
                                 f"{np.nonzero(got != expected)[0].tolist()}")
    return _point(n, seconds, args.batch)


def measure_processes(args, n, device_type):
    # the lanes of ``_batch``, rank r verifying [r*B, (r+1)*B)
    argv = (["--circuit", "tiny"] if args.tiny else
            ["--circuit", STEP, "--corrupt", str(CORRUPT_LANE)])
    argv += ["--local-batch", str(args.batch), "--iters", str(args.iters + 1)]
    if device_type == "cpu":
        argv += ["--device", "cpu"]
    results = dist_worker.launch(n, argv, timeout=RANKS_TIMEOUT_S)
    expected = _expected(args, n * args.batch).tolist()
    for r in results:
        if r["verdicts"] != expected:
            raise AssertionError(f"{n} processes: rank {r['rank']} got other "
                                 f"verdicts")
    return dict(_point(n, results[0]["seconds"][1:], args.batch),
                backend=results[0]["backend"])


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plonky2_tpu_torch.tools.scaling_bench")
    ap.add_argument("--sizes", default="1,2,4,8",
                    help="mesh sizes, comma-separated")
    ap.add_argument("--processes", default="",
                    help="process counts, comma-separated (default: none)")
    ap.add_argument("--batch", type=int, default=256,
                    help="proofs per device or process")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="CPU devices and gloo ranks (not a device measurement)")
    ap.add_argument("--tiny", action="store_true",
                    help="dummy proofs of the tiny spec instead of step")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the JSON line to FILE")
    args = ap.parse_args(argv)
    try:
        device = verifier.resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        print(f"scaling_bench: {e}; pass --cpu", file=sys.stderr)
        return 2
    if device.type == "cuda":
        from ..kernels import build
        build.library()  # built once here, before any rank starts
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        name = verifier.device_name(device)
    else:
        devices, name = None, "cpu"

    def available(n):
        return devices is None or n <= len(devices)

    def not_measured(n):
        return {"n": n, "status": "not measured",
                "reason": f"{len(devices)} GPU(s) on this machine"}

    def sweep(counts, measure):
        points = []
        for n in (int(c) for c in counts.split(",") if c):
            if not available(n):
                points.append(not_measured(n))
                continue
            p = measure(n)
            points.append(p)
            base = next((q for q in points if q["n"] == 1), None)
            p["efficiency_vs_1"] = (p["proofs_per_s"]
                                    / (base["proofs_per_s"] * n)
                                    if base else None)
        return points

    report = {
        "metric": "verified proofs/s, weak scaling",
        "device": name, "device_count": len(devices) if devices else None,
        "workload": (f"{'tiny spec dummy proofs' if args.tiny else 'step'}, "
                     f"{args.batch} per device or process"),
        "mesh": sweep(args.sizes, lambda n: measure_mesh(
            args, n, devices or [torch.device("cpu")] * n)),
        "processes": sweep(args.processes, lambda n: measure_processes(
            args, n, device.type)),
    }
    if device.type == "cpu":
        report["caveat"] = ("CPU devices share this host's cores: the points "
                            "check the harness, they measure no device")
    line = json.dumps(report)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
