"""One rank of a ``parallel/distributed.py`` job, and the launcher that
starts a job's ranks as subprocesses of one host.

    python -m plonky2_tpu_torch.tools.dist_worker --rank R --world-size N
        --init-method tcp://localhost:PORT --out FILE
        [--backend nccl|gloo] [--device cuda:K|cpu]
        [--circuit testdata/step | tiny] [--local-batch B] [--corrupt G,...]
        [--iters K] [--unequal-check]

Rank R verifies global lanes [R*B, (R+1)*B): copies of the circuit's proof,
with ``corrupt_wires_opening`` applied at the global lanes listed in
``--corrupt`` (with ``tiny``, dummy proofs of the tiny spec, all invalid).
It calls ``verify_batch_distributed`` ``--iters`` times and writes a JSON
object to ``--out``: the verdicts and accept count of the first call, the
kernel launches of that call, the seconds of every call and the device.
With ``--unequal-check`` it then passes a tiny batch of R + 1 lanes, and a
tiny batch of two query rounds of which rank 1 keeps one; each must raise
``ValueError`` on every rank, and the messages are recorded.

``launch`` starts the N ranks, one process each, waits for them with a time
limit, stops every one it started, and returns their JSON objects.  A GPU
caller builds the kernels first (``kernels.build.library()``), so the ranks
find the library rather than build it at once.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from .. import verifier
from ..kernels import launches as kernel_launches
from ..parallel import distributed
from ..proof import serde
from ..proof.fixtures import corrupt_wires_opening, load_fixture
from ..proof.synthetic import make_dummy_proof, make_tiny_spec

ROOT = Path(__file__).resolve().parents[2]


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tail(path, n=3000):
    text = Path(path).read_text(errors="replace")
    return text[-n:]


def launch(world_size, argv, timeout):
    """Run ranks 0..world_size-1 with ``argv`` added to each command line;
    returns their JSON objects in rank order.  Raises RuntimeError when a
    rank fails or the time limit passes; every rank still running is killed
    either way."""
    port = free_port()
    procs, outs, logs = [], [], []
    try:
        for rank in range(world_size):
            for paths in (outs, logs):
                fd, path = tempfile.mkstemp(prefix=f"p2t_rank{rank}_")
                os.close(fd)
                paths.append(path)
            cmd = [sys.executable, "-m", "plonky2_tpu_torch.tools.dist_worker",
                   "--rank", str(rank), "--world-size", str(world_size),
                   "--init-method", f"tcp://localhost:{port}",
                   "--out", outs[rank], *argv]
            with open(logs[rank], "w") as log:
                procs.append(subprocess.Popen(
                    cmd, cwd=ROOT, env=dict(os.environ, LOCAL_RANK=str(rank)),
                    stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            rcs = [p.poll() for p in procs]
            if None not in rcs or any(rc not in (None, 0) for rc in rcs):
                break
            time.sleep(0.1)
        rcs = [p.poll() for p in procs]
        if rcs != [0] * world_size:
            detail = "\n".join(f"-- rank {r}: exit {rc}\n{_tail(logs[r])}"
                               for r, rc in enumerate(rcs))
            raise RuntimeError(f"distributed ranks failed or passed the "
                               f"{timeout} s limit (exit None = killed):\n"
                               f"{detail}")
        results = []
        for path in outs:
            with open(path) as f:
                results.append(json.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for path in outs + logs:
            os.unlink(path)


def load_circuit(circuit):
    """(spec, raw, vraw) of a fixture directory (relative to the repository
    root), or (the tiny spec, None, None) for ``tiny``."""
    if circuit == "tiny":
        return make_tiny_spec(), None, None
    return load_fixture(ROOT / circuit)


def make_lanes(circuit, first, count, corrupt=()):
    """The batch of global lanes [first, first + count): copies of the
    circuit's proof, ``corrupt_wires_opening`` at the lanes in ``corrupt``;
    for the tiny spec, dummy proof g at lane g."""
    spec, raw, vraw = circuit
    lanes = range(first, first + count)
    if raw is None:
        return serde.stack_proofs([make_dummy_proof(spec, seed=g)
                                   for g in lanes])
    good = serde.ingest_proof(spec, raw, vraw)
    bad = serde.ingest_proof(spec, corrupt_wires_opening(raw), vraw)
    return serde.stack_proofs([bad if g in corrupt else good for g in lanes])


def _raised(spec, local_batch, device):
    """The message of the ValueError that verifying ``local_batch`` raises,
    or None."""
    try:
        distributed.verify_batch_distributed(spec, local_batch, device)
    except ValueError as e:
        return str(e)
    return None


def run(args):
    device = distributed.local_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)  # CPU ranks share the host's cores
    distributed.initialize(args.backend, args.init_method, args.world_size,
                           args.rank, device)
    circuit = load_circuit(args.circuit)
    local = make_lanes(circuit, args.rank * args.local_batch,
                       args.local_batch, args.corrupt)

    kernel_launches.reset()
    seconds, first = [], None
    for _ in range(args.iters):
        t0 = time.perf_counter()
        out = distributed.verify_batch_distributed(circuit[0], local, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        if first is None:
            first = out
            launches = kernel_launches.read()
    result = {"rank": args.rank, "world_size": args.world_size,
              "backend": torch.distributed.get_backend(),
              "device": verifier.device_name(device),
              "local_batch": args.local_batch,
              "verdicts": first[0].tolist(), "n_accept": first[1],
              "launches": launches, "seconds": seconds}
    if args.unequal_check:
        spec = make_tiny_spec()
        uneven = serde.stack_proofs([make_dummy_proof(spec, seed=i)
                                     for i in range(args.rank + 1)])
        result["unequal_error"] = _raised(spec, uneven, device)
        spec2 = make_tiny_spec(num_query_rounds=2)
        batch = serde.stack_proofs([make_dummy_proof(spec2)])
        if args.rank == 1:  # one query round of the circuit's two
            qkeys = serde.query_axis_keys(spec2)
            batch = {k: (v[:, :1] if k in qkeys else v)
                     for k, v in batch.items()}
        result["query_round_error"] = _raised(spec2, batch, device)
    with open(args.out, "w") as f:
        json.dump(result, f)
    torch.distributed.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plonky2_tpu_torch.tools.dist_worker")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: from the device)")
    ap.add_argument("--device", default=None,
                    help="default cuda:{LOCAL_RANK}; cpu for the CPU")
    ap.add_argument("--circuit", default="testdata/step",
                    help="a fixture directory, or 'tiny' for dummy proofs "
                         "of the tiny spec")
    ap.add_argument("--local-batch", type=int, default=1)
    ap.add_argument("--corrupt", default="",
                    help="global lanes to corrupt, comma-separated")
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--unequal-check", action="store_true")
    args = ap.parse_args(argv)
    args.corrupt = {int(g) for g in args.corrupt.split(",") if g}
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
