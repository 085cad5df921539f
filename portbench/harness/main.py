"""One run of one cell: set-up, the measured window, the check, the line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell's mix names the loop that drives the window (``loops/<loop>.py``)
and the system that it calls (``systems/<system>.py``), each on the next of
the plan's distinct batches. With ``--trace 0`` the run reports the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, from a window
of calls through the system's own steps under the port's stage timer and
then a profiled stretch of plain calls. Every call's
outputs are checked against the plain reference once the window has
closed. The last line of standard output is the result, and the numbers
compared, each with its limit, are the last lines of standard error.
Without the cell's CUDA devices the run exits 2, and if JAX or the JAX
package (``FORBIDDEN``, compared by whole top-level names) was loaded by
the end, 3; neither prints a result.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import os
import statistics
import sys
import time

from . import catalog as catalog_mod
from . import check, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "plonky2_tpu")
PLATFORM = "gpu"


class NoChip(RuntimeError):
    pass


class Run:
    """What a run recorded, handed to each metric's reader."""

    def __init__(self, cell, config, mix, spec):
        self.cell, self.config, self.mix = cell, config, mix
        self.spec = spec  # the plain reference's parse of the circuit
        self.batch_size = mix["batch_size"]
        self.setup_s = None
        self.setup_phases = {}  # s from each mark of set-up to the next
        self.latencies = []  # host seconds of each call in the window
        self.starts = []  # each call's start, s from the window's
        self.window_s = None
        self.stages = []  # {stage: s} of each staged call (traced run)
        self.profile = None  # trace.reduce_events' summary (traced run)
        self.device_name = None
        self.memory_reserved_peak = None

    @property
    def lanes_done(self):
        return self.batch_size * len(self.latencies)


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Top-level names of ``sys.modules`` that are JAX or the JAX package,
    compared whole (``plonky2_tpu_torch`` is not ``plonky2_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def require_chip(chips):
    import torch

    if not torch.cuda.is_available():
        raise NoChip("no CUDA device: the benchmark runs on the GPU only")
    if torch.cuda.device_count() < chips:
        raise NoChip(f"{torch.cuda.device_count()} CUDA devices, the cell "
                     f"asks for {chips}")


def run_cell(args, t_start, system_factory=None, catalog=None,
             chip_check=require_chip):
    """One run; returns (the result's dict, notes for standard error: the
    set-up's phases and the window's calls). ``attempted`` counts the lanes
    of every call checked (the set-up's call on each distinct batch and
    every call of the window), ``failed`` those wrong in any output.
    ``system_factory(circuit_dir)`` makes the system under test (the mix's
    ``systems/<system>.py`` by default); ``chip_check(chips)`` raises
    ``NoChip`` where the cell cannot run."""
    from portbench.reference.plain_verifier import load_spec

    from . import traffic

    catalog = catalog or catalog_mod.Catalog()
    cell = catalog.cell(args.workload)
    config = catalog.config(cell["config"])
    mix = catalog.traffic(cell["traffic"])
    loop = catalog.loop(mix["loop"])
    system_factory = system_factory or catalog.system(mix["system"])
    chip_check(cell["chips"])
    os.environ.update(mix.get("env", {}))
    import torch

    # the deployment's host threads, as the configuration states them
    torch.set_num_threads(config["host_threads"])

    circuit_dir = config["circuit_dir"]
    spec = load_spec(circuit_dir / "common_circuit_data.json")
    check_config(config, spec)
    run = Run(cell, config, mix, spec)

    # set-up: the seeded plan, ingest and stacking, the key's capture, one
    # call on every distinct batch
    marks = [("start", t_start), ("imports", time.perf_counter())]
    plan = traffic.make_plan(circuit_dir, mix, args.seed)
    marks.append(("plan", time.perf_counter()))
    system = system_factory(circuit_dir)
    system.load(plan)
    marks.append(("ingest", time.perf_counter()))
    n = len(plan.batches)
    calls = [(0, system.verify(0))]
    marks.append(("first_call", time.perf_counter()))
    calls += [(i, system.verify(i)) for i in range(1, n)]
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    # what set-up made stays to the end: keep the collector off it, so that
    # no call of the window pays for a full collection of it
    gc.collect()
    gc.freeze()
    marks.append(("other_batches", time.perf_counter()))
    run.setup_s = marks[-1][1] - t_start
    run.setup_phases = {name: t - t0 for (_, t0), (name, t)
                        in zip(marks, marks[1:])}

    # the window
    if not args.trace:
        window, run.latencies, run.starts, run.window_s = loop(
            system.verify, n, args.seconds, mix)
        calls += window
    else:
        staged, run.latencies, run.starts, run.window_s = loop(
            system.verify_staged, n, args.seconds, mix)
        calls += [(i, out) for i, (out, _) in staged]
        run.stages = [stages for _, (_, stages) in staged]
        counter = itertools.count(len(staged))

        def next_call():
            i = next(counter) % n
            return i, system.verify(i)

        run.profile, profiled = trace.profile(
            next_call, mix["profile_calls"],
            torch.device("cuda") if cuda else None)
        calls += profiled

    if cuda:
        run.device_name = torch.cuda.get_device_name()
        run.memory_reserved_peak = torch.cuda.max_memory_reserved()
    system.release()

    answers = check.reference_answers(circuit_dir, plan)
    want = check.expected(plan, answers)
    checks, wrong = check.compare(calls, want)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in catalog.metrics(cell["name"], bool(args.trace)):
        value = catalog.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": PLATFORM, "kind": run.device_name,
              "count": cell["chips"],
              "memory_peak_bytes": run.memory_reserved_peak}
    result = {"correct": correct,
              "attempted": run.batch_size * len(calls),
              "failed": wrong, "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
        result["breakdown"] = trace.breakdown(run.profile)
    result["checks"] = checks
    notes = {"setup_s by phase": run.setup_phases,
             "window": window_summary(run)}
    if args.trace:
        notes["profiled stretch"] = trace.stretch_summary(run.profile)
    return result, notes


def window_summary(run):
    """Calls, seconds, the calls' host ms at their quartiles and ends, and
    their median in each tenth of the window (with the stage ``convert``'s
    in a traced run), which shows whether a run drifts: printed on standard
    error, for the reader of a run."""
    lat = [x * 1e3 for x in run.latencies]
    if len(lat) < 2:
        return {"calls": len(lat)}
    ordered = sorted(lat)
    q1, q2, q3 = statistics.quantiles(ordered, n=4)
    summary = {"calls": len(lat), "seconds": run.window_s,
               "call_ms": {"min": ordered[0], "q1": q1, "median": q2,
                           "q3": q3, "p95": p95(ordered),
                           "max": ordered[-1]},
               "call_ms by tenth": by_tenth(run.starts, lat, run.window_s)}
    if run.stages and all("convert" in s for s in run.stages):
        summary["convert_ms by tenth"] = by_tenth(
            run.starts, [s["convert"] * 1e3 for s in run.stages],
            run.window_s)
    return summary


def by_tenth(starts, values, seconds):
    """The median of ``values`` over the calls that start in each tenth of
    ``seconds``."""
    bins = [[] for _ in range(10)]
    for t, v in zip(starts, values):
        bins[min(9, int(10 * t / seconds))].append(v)
    return [statistics.median(b) if b else None for b in bins]


def check_config(config, spec):
    """Raise unless every published size that the configuration file
    states is the circuit's as parsed."""
    sizes = {"degree_bits": spec.degree_bits, "num_wires": spec.num_wires,
             "num_routed_wires": spec.num_routed_wires,
             "num_public_inputs": spec.num_public_inputs,
             "num_query_rounds": spec.num_query_rounds,
             "reduction_arity_bits": list(spec.reduction_arity_bits),
             "rate_bits": spec.rate_bits, "cap_height": spec.cap_height,
             "proof_of_work_bits": spec.pow_bits,
             "num_challenges": spec.num_challenges,
             "gate_types": len(spec.gate_ids)}
    for key, value in sizes.items():
        if config[key] != value:
            raise ValueError(f"configuration {config['name']}: {key} is "
                             f"{config[key]}, the circuit's {value}")


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    try:
        result, notes = run_cell(args, t_start)
    except NoChip as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in the run: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, note in notes.items():
        print(f"{name}: {json.dumps(note)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def p95(values):
    """The 95th percentile by nearest rank."""
    ordered = sorted(values)
    return ordered[max(0, -(-95 * len(ordered) // 100) - 1)]


def mean(values):
    return statistics.fmean(values) if values else None
