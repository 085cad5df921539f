"""Microbenchmark: Poseidon-BN254 permutation chains on one device.

Counterpart of ``tools/micro_pb.py``: chains of dependent permutations over a
wide lane batch -- the shape of the leaf and Merkle hashing inside FRI
(reference fri/fri.go:97-157) -- at two chain lengths, under
``PLONKY2_TPU_PB_IMPL=mxu`` (kernel A) and ``cios`` (the CIOS kernel), one
launch a chain step.  The time per launch is the difference between the two
chains' times over the difference of their lengths, so a fixed cost per
chain (the first launch, the synchronisation) cancels; the time per
permutation is that over the lane count.

    python -m plonky2_tpu_torch.tools.micro_pb [--lanes 7168] [--cpu]
        [--out FILE]

7168 lanes is the main path's leaf-scan width (step B=256 x 28 query
rounds).  The chains are ``STEPS`` = 5 and 25 launches long, as in the JAX
tool, each timed with CUDA events, best of ``REPS`` = 2 runs after a warm-up;
both settings must give the same chain output.  Prints one JSON line (also
written to ``--out``); runs on the GPU unless ``--cpu`` (the plain torch
version, timed on the host clock; exit 2 without a GPU and without
``--cpu``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import verifier
from ..fields import bn254
from ..hash import poseidon_bn254 as pb

STEPS = (5, 25)  # the two chain lengths
REPS = 2         # timed runs of each chain; the best counts


def random_states(lanes, device, seed=0):
    """(lanes, 4, 16) canonical Montgomery limbs of values below 2^62."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 62, size=(lanes, 4))
    limbs = [[bn254.int_to_mont_limbs(int(v)) for v in row] for row in vals]
    return torch.as_tensor(np.asarray(limbs, dtype=np.int64), device=device)


def chain(state, steps):
    for _ in range(steps):
        state = pb.permute(state)
    return state


def chain_ms(state, steps, reps):
    """(best ms of a chain of ``steps`` permutations over ``reps`` runs, its
    output)."""
    cuda = state.device.type == "cuda"
    best = float("inf")
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(state.device)
            start.record()
            out = chain(state, steps)
            end.record()
            torch.cuda.synchronize(state.device)
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            out = chain(state, steps)
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best, out


def run(device, lanes=7168):
    """Both settings' chains at both lengths; the report as a dict."""
    n1, n2 = STEPS
    state = random_states(lanes, device)
    report = {"device": verifier.device_name(device), "lanes": lanes,
              "steps": [n1, n2], "impls": {}}
    outs = {}
    for impl in pb.IMPLS:
        with pb.use_impl(impl):
            chain(state, 1)  # warm-up: constant tables, kernel load
            t1, _ = chain_ms(state, n1, REPS)
            t2, outs[impl] = chain_ms(state, n2, REPS)
        per_launch = (t2 - t1) / (n2 - n1)
        report["impls"][impl] = {
            "chain_ms": [t1, t2], "ms_per_launch": per_launch,
            "ns_per_permutation": per_launch * 1e6 / lanes,
            "permutations_per_s": lanes / per_launch * 1e3}
    first, *rest = outs.values()
    if any(not torch.equal(first, o) for o in rest):
        raise AssertionError("the Poseidon-BN254 settings disagree on a chain")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plonky2_tpu_torch.tools.micro_pb")
    ap.add_argument("--lanes", type=int, default=7168)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain version on the CPU")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the JSON line to FILE")
    args = ap.parse_args(argv)
    try:
        device = verifier.resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        print(f"micro_pb: {e}; pass --cpu", file=sys.stderr)
        return 2
    line = json.dumps(run(device, args.lanes))
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
