"""Profiling and observability of the verifier.

Counterpart of ``plonky2_tpu/utils/profiling.py``:

- ``StageTimer``: host wall-clock seconds per named stage, each stage ended
  by ``torch.cuda.synchronize()`` on a CUDA device so the device work lands
  in the stage that issued it; one JSON object per report.
- ``trace``: a ``torch.profiler`` trace of the CPU and (where there is one)
  the GPU, written as a Chrome trace (open in Perfetto or chrome://tracing).
- ``device_kernels``: one run of a function under ``torch.profiler`` on a
  GPU, with its device events, busy time and each hand-written kernel's
  launches and device time; the way to count the kernels a CUDA graph's
  replay launches, which the wrappers' counters do not see.
- ``flops_report``: static per-proof operation counts from the circuit spec
  (Poseidon permutations, quadratic-extension products), the same dict as
  the JAX function, key for key.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; writes ``log_dir/trace.json`` (Chrome trace)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulates named wall-clock timings; prints one JSON object."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.timings = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings[name] = time.perf_counter() - t0

    def report(self, **extra):
        out = dict(self.timings)
        out.update(extra)
        return json.dumps(out)


# A profile whose device trace came back empty is taken again, at most
# EMPTY_TRACE_RETRIES times: on the H100 a short graph replay's profile has
# come back without the kernels it launched (PERF.md §6).
EMPTY_TRACE_RETRIES = 2


def device_kernels(fn, device, names=None):
    """fn() once under ``torch.profiler``, ended by ``cuda.synchronize``:
    (wall s, device kernel and copy events seen, device busy s, {kernel:
    (launches, device s)}) for each name of ``names`` ({kernel: a substring
    of its device name}, by default ``kernels.launches.DEVICE_NAMES``).  A
    trace of no device event at all runs fn() again under a new profile
    (``device_kernels.empty_traces`` counts them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..kernels.launches import DEVICE_NAMES

    names = DEVICE_NAMES if names is None else names
    for attempt in range(EMPTY_TRACE_RETRIES + 1):
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        on_device = [e for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
        if on_device or attempt == EMPTY_TRACE_RETRIES:
            break
        device_kernels.empty_traces += 1
    busy = sum(e.time_range.elapsed_us() for e in on_device) / 1e6
    per_kernel = {}
    for key, needle in names.items():
        hits = [e for e in on_device if needle in e.name]
        per_kernel[key] = (len(hits),
                           sum(e.time_range.elapsed_us() for e in hits) / 1e6)
    return wall, len(on_device), busy, per_kernel


device_kernels.empty_traces = 0


def flops_report(spec) -> dict:
    """Static per-proof cost model from the circuit spec.

    Counts the protocol-level unit operations one proof verification
    performs (reference constraint-mass ranking: SURVEY.md section 3.5).
    """
    Q = spec.num_query_rounds
    arities = [1 << b for b in spec.reduction_arity_bits]
    n_openings = (spec.num_constants + spec.num_routed_wires + spec.num_wires
                  + spec.num_challenges * (1 + spec.num_partial_products)
                  + spec.num_quotient_polys + spec.num_challenges)

    # Poseidon-BN254 permutations: initial-tree leaf hashes + paths, then
    # per reduction step leaf hashes + paths.
    leaf_elems = [spec.num_constants + spec.num_routed_wires, spec.num_wires,
                  spec.num_challenges * (1 + spec.num_partial_products),
                  spec.num_quotient_polys]
    leaf_perms = sum((n + 8) // 9 for n in leaf_elems)
    init_path_perms = 4 * spec.initial_tree_depth
    step_perms = 0
    for j, a in enumerate(arities):
        step_perms += (2 * a + 8) // 9 + spec.step_tree_depths[j]
    bn254_perms = Q * (leaf_perms + init_path_perms + step_perms)

    # Poseidon-GL permutations: transcript + public-input hash.
    from ..transcript.challenger import build_schedule
    gl_perms = build_schedule(spec).n_perms + (spec.num_public_inputs + 7) // 8

    # QE multiplications in FRI combine + fold + final poly.
    qe_muls_fri = Q * (n_openings + sum(3 * a * a for a in arities)
                       + spec.final_poly_len)
    # PLONK vanishing: permutation argument + gate constraints (approx.:
    # num_gate_constraints terms alpha-combined per challenge).
    qe_muls_plonk = spec.num_challenges * (
        2 * spec.num_routed_wires + spec.num_gate_constraints * 2)

    return {
        "poseidon_bn254_permutations": bn254_perms,
        "poseidon_gl_permutations": gl_perms,
        "fri_qe_muls": qe_muls_fri,
        "plonk_qe_muls": qe_muls_plonk,
        "fri_query_rounds": Q,
        "degree_bits": spec.degree_bits,
    }
