"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix and which metrics it reports; everything else is a file of
its own under ``portbench/``, found by its name:

- ``configs/<config>.json``: the circuit and its published sizes;
- ``traffic/<traffic>.json``: the parameters of the one generator
  (``harness/traffic.py``), and the names of the loop and the system that
  the mix drives;
- ``loops/<loop>.py``: ``run(call, batches, seconds, mix)``, which calls
  ``call(i)`` over the window and returns (each call's (i, result), each
  call's host seconds, each call's start, the window's seconds);
- ``systems/<system>.py``: ``System(circuit_dir)``, the system under test,
  with ``load(plan)`` (set-up), ``verify(i)`` (the timed call on batch i),
  ``verify_staged(i)`` (the same under the program's stage timer:
  (outputs, {stage: s})) and ``release()``;
- ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``.

A new cell, configuration, mix, loop, system or metric is new files and new
entries in ``BENCHMARK.json``; no file here changes. A name with no file is
refused.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from . import traffic as traffic_mod

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Catalog:
    """The benchmark's entries, read from ``BENCHMARK.json`` under ``root``
    and the data files under ``root/portbench``."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.dir = self.root / BENCH_DIR.name
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def cell(self, name):
        for cell in self.bench["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        with open(self.dir / "configs" / f"{name}.json") as f:
            config = json.load(f)
        config["circuit_dir"] = self.dir / config["circuit"]
        return config

    def traffic(self, name):
        """The mix, refused where it has a key or a kind that the generator
        does not know."""
        with open(self.dir / "traffic" / f"{name}.json") as f:
            mix = json.load(f)
        traffic_mod.check_mix(mix, name)
        return mix

    def metrics(self, cell_name, traced):
        """The metric entries this cell reports: its end-to-end metrics, or
        with ``traced`` its per-layer ones (a metric without a
        ``workloads`` key is in every cell)."""
        group = self.bench["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if cell_name in m.get("workloads", [cell_name])]

    def reader(self, metric_name):
        """``read`` of ``metrics/<metric_name>.py``."""
        return self._module("metrics", metric_name).read

    def loop(self, name):
        """``run`` of ``loops/<name>.py``."""
        return self._module("loops", name).run

    def system(self, name):
        """``System`` of ``systems/<name>.py``."""
        return self._module("systems", name).System

    def _module(self, kind, name):
        path = self.dir / kind / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {kind} file {path.name!r} for {name!r}")
        module_name = f"portbench_{kind}_" + name.replace(".", "_")
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
