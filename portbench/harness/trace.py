"""The traced run's profiled stretch: a few calls under ``torch.profiler``,
reduced to what the per-layer readers and the result's ``breakdown`` need.

Everything is read from the trace's own timeline. Each call runs inside the
host span ``CALL_SPAN``; the profiler takes one call more than the stretch
holds, and the stretch runs from the start of the second call's span to the
end of the last one's, so that the first call's profiler start-up is left
out. Its device busy time is the union of every kernel, copy and set
interval that starts in it, cut at its end; its idle time is the rest.
Under the profiler each graph launch holds the host longer than without it
(CUPTI records the graph's kernels), and the profiler flushes its buffers on
the host: those gaps are named in ``breakdown`` and count as idle. An idle gap, a stretch of that window
in which nothing ran on the card, is named by the innermost host event
under its middle: a torch operation or CUDA runtime call of the program,
else ``verify_batch (python, numpy)`` for the harness's span of the call,
else ``between calls``; gaps under ``SHORT_GAP_US`` (the thousands between
a replay's kernels) are summed under one name.
"""

from __future__ import annotations

import collections

CALL_SPAN = "portbench.call"
EMPTY_TRACE_RETRIES = 2  # a profile with no device event is taken again
SHORT_GAP_US = 20  # shorter gaps are summed under one name, not looked up
SHORT_GAPS = f"short gaps (< {SHORT_GAP_US} us each)"


def _is_copy(name):
    return name.startswith(("Memcpy", "Memset"))


def _union(intervals):
    """Sorted disjoint union of (start, end) pairs."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _label(host, t):
    """The innermost host event around time ``t`` (us)."""
    around = [e for e in host if e[0] <= t <= e[1]]
    if not around:
        return "between calls"
    start, end, name = min(around, key=lambda e: e[1] - e[0])
    return "verify_batch (python, numpy)" if name == CALL_SPAN else name


def reduce_events(events):
    """Summary of a profile's ``events()``: the stretch from the start of
    the second ``CALL_SPAN`` to the end of the last, on the trace's clock
    (us)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CPU
                   and e.name == CALL_SPAN)
    if len(spans) < 2:
        return None
    lo, hi = spans[1][0], spans[-1][1]
    # a span of the host (record_function) shows on the device as well,
    # around the work it launched: it is no device operation
    device = [(e.time_range.start, min(e.time_range.end, hi), e.name)
              for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.name != CALL_SPAN and lo <= e.time_range.start < hi]
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU]
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for start, end, name in device:
        if not _is_copy(name):
            kernels[name][0] += 1
            kernels[name][1] += (end - start) / 1e6
    busy = _union((start, end) for start, end, _ in device)
    edges = [lo] + [x for interval in busy for x in interval] + [hi]
    gaps = collections.defaultdict(float)
    for end, start in zip(edges[::2], edges[1::2]):
        if start <= end:
            continue
        name = (SHORT_GAPS if start - end < SHORT_GAP_US
                else _label(host, (end + start) / 2))
        gaps[name] += (start - end) / 1e6
    return {
        "calls": len(spans) - 1,
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(end - start for start, end in busy) / 1e6,
        "call_ms": [(end - start) / 1e3 for start, end in spans[1:]],
        "kernel_events": sum(n for n, _ in kernels.values()),
        "copy_events": sum(1 for _, _, name in device if _is_copy(name)),
        "kernels": {name: tuple(v) for name, v in kernels.items()},
        "gaps": dict(gaps),
    }


def profile(call, calls, device):
    """``call()`` ``calls`` + 1 times under ``torch.profiler``, each inside
    the span ``CALL_SPAN``: (the summary of the last ``calls``, [the
    return value of every call made, those of a profile taken again
    included])."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    results = []
    for _ in range(EMPTY_TRACE_RETRIES + 1):
        if device is not None:
            torch.cuda.synchronize(device)
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(calls + 1):
                with record_function(CALL_SPAN):
                    results.append(call())
            if device is not None:
                torch.cuda.synchronize(device)
        summary = reduce_events(prof.events())
        if summary and summary["kernel_events"]:
            break
    return summary, results


def stretch_summary(summary):
    """What standard error shows of the stretch: its calls' ms on the
    trace's clock (against the window's calls, the profiler's cost a
    call), its length and busy time."""
    if not summary:
        return None
    return {key: summary[key] for key in ("calls", "window_s", "busy_s",
                                          "call_ms", "kernel_events")}


def breakdown(summary, top=10):
    """The result's ``breakdown``: the device operations that took most
    time, and the idle gaps' time by what the host was doing."""
    ops = sorted(((name, s) for name, (_, s) in summary["kernels"].items()),
                 key=lambda x: -x[1])[:top]
    gaps = sorted(summary["gaps"].items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": [[name[:160], s] for name, s in gaps]}
