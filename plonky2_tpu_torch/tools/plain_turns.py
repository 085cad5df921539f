"""The plain Poseidon-BN254 permutation of source trees, timed in turns on
the CPU, one thread.

    python -m plonky2_tpu_torch.tools.plain_turns [--tree DIR]...
        [--lanes 112,448,2352] [--reps 3]

Tree 0 is this checkout; each ``--tree`` adds the root of another checkout
(for example ``git archive`` of an earlier commit, unpacked), trees 1, 2,
...  For each tree in the order 0, 1, ..., k, k, ..., 1, 0 (tree 0 alone
without ``--tree``) one process runs that tree's
``hash/poseidon_bn254.permute_plain`` on one CPU thread at each lane count
(112, 448 and 2352: the lane counts of a decode_block batch of 4 and a step
batch of 3 in the CPU tests' Merkle chains; the states random from one
seed, the first holding 0, 1, p-1, 2), ``--reps`` timed calls after one
warm-up.  The outputs of every process must be equal.  Prints one JSON
line per process, then a summary: per tree and lane count the median
seconds a call and tree 0's median over it.  Exits 1 if the outputs
differ or a process fails.  The plain version is the port's CPU path; no
GPU is used.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SEED = 2024


def _child(lanes, reps):
    import numpy as np
    import torch

    from plonky2_tpu_torch.fields import bn254
    from plonky2_tpu_torch.hash import poseidon_bn254 as pb

    torch.set_num_threads(1)
    rng = np.random.default_rng(SEED)
    seconds, digest = {}, hashlib.sha256()
    for n in lanes:
        vals = rng.integers(0, 1 << 16, size=(n, 4, 16), dtype=np.int64)
        vals[..., 15] &= 0x1FFF  # < 2^253 < p
        vals[0] = np.asarray([bn254.int_to_limbs(v) for v in
                              (0, 1, bn254.P - 1, 2)], dtype=np.int64)
        st = torch.as_tensor(vals)
        out = pb.permute_plain(st)
        digest.update(out.numpy().tobytes())
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            pb.permute_plain(st)
            times.append(time.perf_counter() - t0)
        seconds[str(n)] = times
    print(json.dumps({"seconds": seconds,
                      "digest": digest.hexdigest()[:16]}))


def summarize(runs):
    """Per tree and lane count: the median seconds over the tree's calls,
    and tree 0's median over it."""
    trees = {}
    for run in runs:
        t = trees.setdefault(run["tree"], {})
        for n, times in run["seconds"].items():
            t.setdefault(n, []).extend(times)
    out = {}
    for i, t in trees.items():
        out[i] = {"median_s": {n: sorted(v)[len(v) // 2]
                               for n, v in t.items()}}
    base = out[min(out)]["median_s"]
    for t in out.values():
        t["tree_0_over_this"] = {n: base[n] / s
                                 for n, s in t["median_s"].items()}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plonky2_tpu_torch.tools.plain_turns")
    ap.add_argument("--tree", action="append", default=[],
                    help="root of another checkout (trees 1, 2, ...)")
    ap.add_argument("--lanes", default="112,448,2352")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    lanes = [int(n) for n in args.lanes.split(",")]
    if args.child:  # runs as a script file, on another tree's package
        _child(lanes, args.reps)
        return 0
    from plonky2_tpu_torch.tools.kernel_turns import turn_order

    trees = [REPO] + [Path(t).resolve() for t in args.tree]
    runs = []
    for i in turn_order(len(trees)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             "--lanes", args.lanes, "--reps", str(args.reps)],
            cwd=trees[i], env={**os.environ, "PYTHONPATH": str(trees[i]),
                               "OMP_NUM_THREADS": "1"},
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"plain_turns: tree {i} ({trees[i]}) failed:\n"
                  f"{proc.stderr[-4000:]}", file=sys.stderr)
            return 1
        run = {"tree": i, **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(run))
        runs.append(run)
    if len({run["digest"] for run in runs}) != 1:
        print("plain_turns: the outputs differ", file=sys.stderr)
        return 1
    print(json.dumps({"trees": [str(t) for t in trees],
                      "per_tree": summarize(runs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
