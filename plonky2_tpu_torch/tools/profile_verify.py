"""Phase and stage times of the verifier on one batch.

Counterpart of ``tools/profile_verify.py``, which times three separately
``jax.jit``-compiled programs on arrays already on the device.  Three modes:

``phases`` (the default): the JAX tool's three programs, each captured in a
CUDA graph of its own (``verifier.capture``) on a batch prepared onto the
card once, outside any timing, and replayed:

    transcript  public-input hash, Fiat-Shamir transcript, challenge reads
    plonk       the transcript, then the PLONK vanishing check
    fri         the transcript, then the FRI opening check

For each: the eager warm-up and the capture (``compile_s``, the JAX
``compile=``), the first replay apart, then ``REPS`` replays, each ended by
``torch.cuda.synchronize``: the best and the median wall, and each replay's
device time by CUDA events; one more replay under ``torch.profiler`` counts
its kernels.  ``plonk_only`` and ``fri_only`` are the differences with the
transcript, as in the JAX tool, and the whole compiled verifier's replay
(``verifier.compiled_verifier``) is timed beside them.  Each phase's graph is
released before the next is captured; the peak device memory is reported.

``replayed``: a ``verifier.verify_batch`` call on the compiled path after the
key's first call, its host stages timed apart (``utils.profiling
.StageTimer``, a ``cuda.synchronize`` after each):

    observed    the batch checked against the key's layout, then the observed
                sequence (transcript/challenger.build_observed_host)
    convert     the batch's bytes packed into the key's pinned buffer
                (CompiledVerifier.load)
    copy_in     one host-to-device copy of the narrow layout
    replay      the graph's replay, the widening of its inputs included
    outputs     the clones of its outputs
    read_back   device -> host copy of the (B,) outputs
    mask        the ingest mask (verifier.apply_valid_masks)

beside the same call without the timer, whose synchronisations cost a little.

``stages``: the stages of ``verifier.verify_device`` run eagerly (``prepare``,
``pi_hash``, ``transcript``, ``challenges``, ``plonk``, ``fri``,
``verdict``), each ended by ``torch.cuda.synchronize``.

    python -m plonky2_tpu_torch.tools.profile_verify [--circuit testdata/step]
        [--batch 256] [--reps 3] [--mode phases|replayed|stages] [--cpu]

prints one JSON line per repetition.  It runs on the GPU unless ``--cpu``,
which runs the phases eagerly (CUDA graphs need a GPU) and marks the line
``"compiled": false``; without a GPU and without ``--cpu`` it exits 2.  The
Poseidon-BN254 kernel follows ``PLONKY2_TPU_PB_IMPL``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from .. import verifier
from ..fri.verify import verify_fri
from ..hash import poseidon_bn254 as pb
from ..hash import poseidon_gl as pgl
from ..plonk_checks.vanishing import verify_plonk
from ..proof import serde
from ..proof.fixtures import load_fixture
from ..transcript import challenger as chal
from ..utils.profiling import StageTimer, device_kernels

MODES = ("phases", "replayed", "stages")
REPS = 3  # the JAX tool's best of 3


def transcript_phase(spec, schedule, dev, obs):
    """(pi_hash, challenges) of the batch, as ``verify_device`` makes them."""
    pi_hash = pgl.hash_no_pad(dev["public_inputs"])
    states = chal.run_transcript(schedule, obs, pi_hash)
    return pi_hash, verifier._extract_challenges(schedule, states)


def _ones(obs):
    return torch.ones((obs[0].shape[0],), dtype=torch.bool,
                      device=obs[0].device)


def plonk_phase(spec, schedule, dev, obs):
    """The transcript, then the PLONK check: (B,) bool, ``plonk_ok``."""
    pi_hash, challenges = transcript_phase(spec, schedule, dev, obs)
    return verify_plonk(spec, dev, challenges, pi_hash, _ones(obs))


def fri_phase(spec, schedule, dev, obs):
    """The transcript, then the FRI check: (B,) bool, ``fri_ok``."""
    _, challenges = transcript_phase(spec, schedule, dev, obs)
    return verify_fri(spec, dev, challenges, _ones(obs))


PHASES = {"transcript": transcript_phase, "plonk": plonk_phase,
          "fri": fri_phase}


def _runs(run, device, reps):
    """``run()`` ``reps`` times, each ended by ``cuda.synchronize`` on a GPU:
    ({"best_s", "median_s", "replay_s"} from the host clock and, on a GPU,
    the same of each run's device time by CUDA events ("event_*"), the last
    run's result)."""
    cuda = device.type == "cuda"
    walls, events = [], []
    for _ in range(reps):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        result = run()
        if cuda:
            end.record()
            torch.cuda.synchronize(device)
            events.append(start.elapsed_time(end) / 1e3)
        walls.append(time.perf_counter() - t0)
    out = {"replay_s": walls, "best_s": min(walls),
           "median_s": float(np.median(walls))}
    if cuda:
        out.update(event_s=events, event_best_s=min(events),
                   event_median_s=float(np.median(events)))
    return out, result


def _kernels(run, device):
    """One ``run()`` under torch.profiler: device events, busy s and each
    hand-written kernel's launches."""
    wall, n_events, busy, per_kernel = device_kernels(run, device)
    return {"profiled_wall_s": wall, "device_events": n_events,
            "busy_s": busy,
            "kernels": {k: n for k, (n, _) in per_kernel.items()}}


def _timed_graph(fn, device, reps):
    """Capture ``fn`` (``verifier.capture``), replay it: (times, the last
    replay's outputs as numpy arrays).  The graph is released on return."""
    graph, outputs, warmup_s, capture_s = verifier.capture(fn, device)
    out = {"warmup_s": warmup_s, "capture_s": capture_s,
           "compile_s": warmup_s + capture_s,
           "first_replay_s": _runs(graph.replay, device, 1)[0]["best_s"]}
    out.update(_runs(graph.replay, device, reps)[0])
    out.update(_kernels(graph.replay, device))
    return out, _host(outputs)


def _host(tree):
    """A nest of tensors -> the same nest of numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return type(tree)(_host(v) for v in tree)


def _whole(spec, schedule, batch, dev, obs, device, reps):
    """The whole verifier on ``batch``: the compiled verifier's replay on a
    GPU (its key's graph, captured here if it is new, the batch loaded
    first), the eager ``verify_device`` on the prepared tensors on the
    CPU.  (times, its {"verdict", "plonk_ok", "fri_ok"} as numpy arrays)."""
    if device.type == "cpu":
        out, result = _runs(lambda: verifier.verify_device(
            spec, schedule, dev, obs, diagnostics=True), device, reps)
        return out, _host(result)
    entry = verifier.compiled_verifier(spec, obs[0].shape[0], device,
                                       pb.kernel_impl())
    captured_here = entry.graph is None
    verifier.verify_on_device(spec, batch, device)  # loaded; a new key captures
    torch.cuda.synchronize(device)
    out = {"captured_here": captured_here, "warmup_s": entry.warmup_s,
           "capture_s": entry.capture_s,
           "compile_s": entry.warmup_s + entry.capture_s}
    out.update(_runs(entry.graph.replay, device, reps)[0])
    out.update(_kernels(entry.graph.replay, device))
    return out, _host(entry.outputs)


def profile_phases(spec, batch, device, reps=REPS):
    """Times of the transcript, plonk and fri phases of one verification of
    ``batch``, each captured in its own CUDA graph on a GPU (run eagerly on
    the CPU, ``"compiled": false``), beside the whole verifier's.  Returns
    a JSON-ready dict, plus ``outputs``, as numpy arrays: the plonk and fri
    phases' (B,) bool outputs (``plonk_ok``, ``fri_ok``), the transcript
    phase's (pi_hash, challenges) (``transcript``) and the whole verifier's
    {"verdict", "plonk_ok", "fri_ok"} on the same tensors (``verifier``)."""
    device = verifier.resolve_device(device)
    compiled = device.type == "cuda"
    schedule, dev, obs = verifier.prepare(spec, batch, device)
    if compiled:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    phases, outputs = {}, {}
    with torch.cuda.device(device) if compiled else contextlib.nullcontext():
        for name, phase in PHASES.items():
            def run(phase=phase):
                return phase(spec, schedule, dev, obs)
            if compiled:
                phases[name], outputs[name] = _timed_graph(run, device, reps)
                torch.cuda.empty_cache()  # the graph's pool, released
            else:
                phases[name], out = _runs(run, device, reps)
                outputs[name] = _host(out)
        whole, outputs["verifier"] = _whole(spec, schedule, batch, dev, obs,
                                            device, reps)
    best = {k: v["best_s"] for k, v in phases.items()}
    report = {"compiled": compiled, "phases": phases, "whole": whole,
              "plonk_only_s": best["plonk"] - best["transcript"],
              "fri_only_s": best["fri"] - best["transcript"],
              "plonk_plus_fri_less_transcript_s":
                  best["plonk"] + best["fri"] - best["transcript"]}
    if compiled:
        ev = {k: v["event_best_s"] for k, v in phases.items()}
        report.update(
            plonk_only_event_s=ev["plonk"] - ev["transcript"],
            fri_only_event_s=ev["fri"] - ev["transcript"],
            peak_allocated_mib=torch.cuda.max_memory_allocated(device) / 2**20,
            peak_reserved_mib=torch.cuda.max_memory_reserved(device) / 2**20)
    report["outputs"] = {"plonk_ok": outputs["plonk"],
                         "fri_ok": outputs["fri"],
                         "transcript": outputs["transcript"],
                         "verifier": outputs["verifier"]}
    return report


def profile_replayed(spec, batch, device, reps=REPS):
    """Host stages of ``verifier.verify_batch`` on ``batch`` after the key's
    first call, ``reps`` times, each beside the same call without a timer.
    Returns a JSON-ready dict (``stages``: each stage's median s; ``stage_sum_s``
    their sum; ``unprobed_s``, ``unprobed_median_s``: the calls without a
    timer), plus ``verdicts`` and ``unprobed_verdicts``, (B,) bool numpy
    arrays, quarantined lanes False.  On the CPU the call runs
    ``verify_device`` eagerly and its stages stand in for the graph's
    (``"compiled": false``)."""
    device = verifier.resolve_device(device)
    compiled = device.type == "cuda"
    if compiled:
        verifier.verify_batch(spec, batch, device=device)  # the key's first
    reps_stages, walls = [], []
    for _ in range(reps):
        timer = StageTimer(device)
        out = verifier.verify_on_device(spec, batch, device, timer=timer)
        with timer.stage("read_back"):
            out = {k: v.cpu().numpy() for k, v in out.items()}
        with timer.stage("mask"):
            verdicts = verifier.apply_valid_masks(out["verdict"], batch)
        reps_stages.append(timer.timings)
        if compiled:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        unprobed = verifier.verify_batch(spec, batch, device=device)
        walls.append(time.perf_counter() - t0)
    stages = {k: float(np.median([s[k] for s in reps_stages]))
              for k in reps_stages[0]}
    return {"compiled": compiled, "stages": stages,
            "stage_sum_s": sum(stages.values()),
            "stage_reps": reps_stages, "unprobed_s": walls,
            "unprobed_median_s": float(np.median(walls)),
            "verdicts": verdicts, "unprobed_verdicts": unprobed}


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


def load_batch(circuit, batch_size):
    """(spec, a batch of ``batch_size`` copies of the circuit's proof)."""
    spec, raw, vraw = load_fixture(circuit)
    proof = serde.ingest_proof(spec, raw, vraw)
    return spec, serde.stack_proofs([proof] * batch_size)


def run_mode(mode, spec, batch, device):
    """One repetition of ``mode``: (JSON-ready dict, every lane valid)."""
    if mode == "phases":
        out = profile_phases(spec, batch, device)
        ok = out.pop("outputs")
        return out, bool((ok["plonk_ok"] & ok["fri_ok"]).all())
    if mode == "replayed":
        out = profile_replayed(spec, batch, device)
        ok = out.pop("verdicts").all() & out.pop("unprobed_verdicts").all()
        return out, bool(ok)
    st = profile_stages(spec, batch, device)
    ok = bool(st.pop("verdicts").all())
    return {"compiled": False, "seconds": st}, ok


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plonky2_tpu_torch.tools.profile_verify")
    ap.add_argument("--circuit", default="testdata/step")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--mode", choices=MODES, default="phases")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    try:
        device = verifier.resolve_device(device)
    except RuntimeError as e:
        print(f"profile_verify: {e}; pass --cpu", file=sys.stderr)
        return 2

    spec, batch = load_batch(args.circuit, args.batch)
    for rep in range(args.reps):
        out, ok = run_mode(args.mode, spec, batch, device)
        print(json.dumps({"circuit": args.circuit, "batch": args.batch,
                          "rep": rep, "mode": args.mode,
                          "device": verifier.device_name(device),
                          "all_valid": ok, **out}))
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
