"""The cell ``step-b1024-mesh4``: every file of it is found by name, its
three readers give their numbers from a hand-made run and nothing where a
staged call lacks a span, and its system loads nothing of JAX."""

import json
import subprocess
import sys

import pytest

from portbench.harness import catalog, main

CELL = "step-b1024-mesh4"
READERS = ("mesh_feed_ms.mesh4", "mesh_replay_ms.mesh4",
           "mesh_card_busy_pct.mesh4")


def test_cell_files_are_found():
    c = catalog.Catalog()
    cell = c.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "step-mesh4", "closed_b1024_16x4", 4)
    config = c.config(cell["config"])
    assert config["circuit_dir"] == c.config("step")["circuit_dir"]
    assert (config["cards"], config["host_threads"]) == (4, 1)
    mix = c.traffic(cell["traffic"])
    assert (mix["batch_size"], mix["system"]) == (1024, "mesh4")
    assert callable(c.loop(mix["loop"])) and callable(c.system("mesh4"))
    assert [m["name"] for m in c.metrics(CELL, False)] == [
        "proofs_per_s", "setup_s"]
    assert [m["name"] for m in c.metrics(CELL, True)] == list(READERS)
    for name in READERS:
        assert callable(c.reader(name))


def _run(stages):
    run = main.Run({"name": CELL}, {}, {"batch_size": 1024}, None)
    run.stages = stages
    return run


def _call(feed, replays, call):
    stages = {"mesh.feed": feed, "mesh.gather": 0.001, "mesh.call": call,
              "mesh.shards": len(replays), "mesh.pad_lanes": 0,
              "mesh.bytes_in": 4 * 50886656}
    stages.update({f"mesh.replay.{k}": s for k, s in enumerate(replays)})
    return stages


CALLS = [_call(0.020, [0.030, 0.031, 0.032, 0.029], 0.060),
         _call(0.024, [0.028, 0.030, 0.030, 0.032], 0.064)]


def test_readers_give_their_numbers():
    c = catalog.Catalog()
    run = _run(CALLS)
    got = {name: c.reader(name)(run) for name in READERS}
    assert got["mesh_feed_ms.mesh4"] == pytest.approx(22.0)
    assert got["mesh_replay_ms.mesh4"] == pytest.approx(32.0)
    assert got["mesh_card_busy_pct.mesh4"] == pytest.approx(
        (100 * 0.0305 / 0.060 + 100 * 0.030 / 0.064) / 2)


@pytest.mark.parametrize("missing", ["mesh.feed", "mesh.replay.3",
                                     "mesh.shards", "mesh.call"])
def test_readers_give_none_without_a_span(missing):
    """A staged call without one span (as a program without the mesh's
    spans gives) makes each reader of that span give None."""
    c = catalog.Catalog()
    calls = [CALLS[0], {k: v for k, v in CALLS[1].items() if k != missing}]
    run = _run(calls)
    readers = {"mesh.feed": ["mesh_feed_ms.mesh4"],
               "mesh.replay.3": READERS[1:], "mesh.shards": READERS[1:],
               "mesh.call": READERS[2:]}[missing]
    for name in READERS:
        value = c.reader(name)(run)
        assert (value is None) == (name in readers), name
    assert all(c.reader(name)(_run([])) is None for name in READERS)


SYSTEM = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.harness import catalog
System = catalog.Catalog().system("mesh4")
system = System(catalog.BENCH_DIR / "circuits" / "step", devices=["cpu"] * 4)
assert system.mesh.shape == {{"proof": 4}}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_system_loads_no_jax():
    out = subprocess.run([sys.executable, "-c",
                          SYSTEM.format(root=str(catalog.ROOT))],
                         capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "plonky2_tpu_torch" in loaded
    assert not loaded & set(main.FORBIDDEN)
