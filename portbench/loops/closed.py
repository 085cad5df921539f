"""A closed loop with one caller: a sequencer or bridge that hands in the
next batch as soon as the last call's verdicts are on the host."""

from __future__ import annotations

import time


def run(call, batches, seconds, mix):
    """Calls ``call(i)`` on batch i, i cycling from 0, until ``seconds``
    have passed: (each call's (i, result), each call's host seconds, each
    call's start in seconds from the first's, the window's seconds from the
    first call's start to the last one's end). The closed loop takes no
    ``loop_args``."""
    if mix.get("loop_args"):
        raise ValueError(f"the closed loop takes no loop_args: "
                         f"{sorted(mix['loop_args'])}")
    results, latencies, starts = [], [], []
    t0 = time.perf_counter()
    end = t0
    i = 0
    while end - t0 < seconds:
        b = i % batches
        t = time.perf_counter()
        out = call(b)
        end = time.perf_counter()
        results.append((b, out))
        latencies.append(end - t)
        starts.append(t - t0)
        i += 1
    return results, latencies, starts, end - t0
