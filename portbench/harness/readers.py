"""Arithmetic shared by the metric readers (``metrics/<name>.py``). Each
function takes a ``main.Run`` and returns a number, or None where the run
recorded nothing to read."""

from __future__ import annotations

from . import counts
from .main import mean, p95


def stage_ms(run, *names):
    """Mean over the staged calls of the named stages' sum, ms, or None
    where a call lacks one of them."""
    if not run.stages or any(n not in s for s in run.stages for n in names):
        return None
    return mean([sum(s[n] for n in names) for s in run.stages]) * 1e3


def kernel_s_per_call(run, patterns):
    """Device seconds a call in the kernels whose names hold one of
    ``patterns``, or None where the profile saw none."""
    prof = run.profile
    if not prof:
        return None
    hits = [s for name, (_, s) in prof["kernels"].items()
            if any(p in name for p in patterns)]
    return sum(hits) / prof["calls"] if hits else None


def roofline_pct(run, patterns):
    """The least time of the batch's Poseidon-BN254 permutations over the
    device time a call spends in the matching kernels, %."""
    peaks = counts.PEAKS.get(run.device_name)
    seconds = kernel_s_per_call(run, patterns)
    if peaks is None or seconds is None:
        return None
    perms = counts.bn254_permutations(run.spec, run.batch_size)
    nbytes = counts.merkle_bytes(run.spec, run.batch_size)
    return 100 * counts.bn254_bound_s(perms, nbytes, peaks) / seconds


def idle_pct(run):
    """Share of the profiled stretch in which nothing ran on the card, %:
    one minus its device busy time over its length, both on the trace's
    clock (the result's ``device.busy_s`` and ``window_s``)."""
    prof = run.profile
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100 * (1 - prof["busy_s"] / prof["window_s"])


def kernels_per_call(run):
    prof = run.profile
    if not prof or not prof["kernel_events"]:
        return None
    return prof["kernel_events"] / prof["calls"]


def proofs_per_s(run):
    return run.lanes_done / run.window_s if run.latencies else None


def latency_p95_ms(run):
    return p95(run.latencies) * 1e3 if run.latencies else None


def reserved_mib(run):
    peak = run.memory_reserved_peak
    return peak / 2**20 if peak else None
