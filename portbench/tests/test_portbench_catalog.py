"""Cells, configurations, mixes and metrics are found by name from files of
their own; a new cell is new files and entries, with no file edited."""

import json
import shutil

import pytest

from portbench.harness import catalog, control, main


def test_every_entry_has_its_files():
    c = catalog.Catalog()
    for cell in c.bench["workloads"]:
        assert c.cell(cell["name"]) is cell
        config = c.config(cell["config"])
        assert (config["circuit_dir"] / "common_circuit_data.json").exists()
        mix = c.traffic(cell["traffic"])
        assert mix["batch_size"] > 0
        assert callable(c.loop(mix["loop"]))
        assert callable(c.system(mix["system"]))
        for traced in (False, True):
            for m in c.metrics(cell["name"], traced):
                assert callable(c.reader(m["name"]))
    for config in c.bench["configs"]:
        assert (catalog.ROOT / config["file"]).exists()


def test_metrics_by_cell():
    c = catalog.Catalog()
    assert [m["name"] for m in c.metrics("decode_block-b4", False)] == [
        "batch_p95_ms", "setup_s"]
    assert [m["name"] for m in c.metrics("step-b64", False)] == [
        "proofs_per_s", "setup_s"]
    assert "replay_ms.lat" in [m["name"]
                               for m in c.metrics("decode_block-b4", True)]


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        catalog.Catalog().cell("no-such-cell")


@pytest.fixture
def tree(tmp_path):
    """A copy of the benchmark (BENCHMARK.json and portbench/)."""
    shutil.copy(catalog.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(catalog.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


SYSTEM = """
from portbench.harness.control import ReferenceSystem


class System(ReferenceSystem):
    pass
"""

LOOP = """
from portbench.loops import closed


def run(call, batches, seconds, mix):
    results, latencies, starts, window = closed.run(call, batches, seconds,
                                                    mix)
    return results, latencies, starts, window
"""


def _run(tree, cell, seconds=0.2):
    args = main.parse(["--workload", cell, "--seed", "5", "--seconds",
                       str(seconds), "--trace", "0"])
    result, _ = main.run_cell(args, 0.0, catalog=catalog.Catalog(tree),
                              chip_check=control.no_chip_check)
    return result


def test_new_cell_by_adding_files(tree, cached_reference):
    """A cell with a new mix, loop, system and per-layer metric runs from
    added files and entries alone, every file that was there unchanged."""
    before = {p: p.read_bytes() for p in (tree / "portbench").rglob("*")
              if p.is_file()}
    bench_dir = tree / "portbench"
    (bench_dir / "traffic" / "closed_b2_2x1.json").write_text(
        json.dumps({"batch_size": 2, "invalid_per_batch": [1, 0],
                    "invalid_proofs": ["pow"], "profile_calls": 2,
                    "loop": "closed_again", "system": "plain"}))
    (bench_dir / "loops" / "closed_again.py").write_text(LOOP)
    (bench_dir / "systems" / "plain.py").write_text(SYSTEM)
    (bench_dir / "metrics" / "calls_done.lat.py").write_text(
        "def read(run):\n    return len(run.latencies)\n")
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "decode_block-b2",
                               "config": "decode_block",
                               "traffic": "closed_b2_2x1", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"][1]["workloads"].append("decode_block-b2")
    bench["per_layer"].append({"name": "calls_done.lat", "unit": "calls",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "batch_p95_ms",
                               "workloads": ["decode_block-b2"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    result = _run(tree, "decode_block-b2")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"batch_p95_ms", "setup_s"}
    assert catalog.Catalog(tree).reader("calls_done.lat")
    for p, data in before.items():
        assert p.read_bytes() == data, p


def _mix_cell(tree, mix):
    """A cell decode_block-x on a mix written from ``mix``."""
    (tree / "portbench" / "traffic" / "x.json").write_text(json.dumps(mix))
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "decode_block-x",
                               "config": "decode_block", "traffic": "x",
                               "chips": 1, "why": "a test cell"})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))


MIX = {"batch_size": 2, "invalid_per_batch": [1], "invalid_proofs": ["pow"],
       "profile_calls": 2, "loop": "closed", "system": "verify_batch"}


@pytest.mark.parametrize("change", [
    {"loop": "open"}, {"system": "no_such_entry"},
    {"host_threads": 1}, {"invalid_proofs": ["no_such_kind"]},
    {"env": {"PLONKY2_TPU_PB_IMPL": 1}}, {"loop": None},
    {"loop_args": [1]}, {"loop_args": {"rate_per_s": 10}, "system": "plain"}])
def test_unknown_mix_values_are_refused(tree, change, cached_reference):
    mix = {k: v for k, v in {**MIX, **change}.items() if v is not None}
    _mix_cell(tree, mix)
    (tree / "portbench" / "systems" / "plain.py").write_text(SYSTEM)
    with pytest.raises((KeyError, ValueError)):
        _run(tree, "decode_block-x")


def test_mix_env_is_set_for_the_program(tree, monkeypatch, cached_reference):
    # set here so that monkeypatch takes the run's setting back out
    monkeypatch.setenv("PORTBENCH_TEST_ENV", "unset")
    _mix_cell(tree, {**MIX, "system": "plain",
                     "env": {"PORTBENCH_TEST_ENV": "cios"}})
    (tree / "portbench" / "systems" / "plain.py").write_text(
        SYSTEM + "\n    def load(self, plan):\n"
        "        import os\n"
        "        assert os.environ['PORTBENCH_TEST_ENV'] == 'cios'\n"
        "        super().load(plan)\n")
    assert _run(tree, "decode_block-x")["correct"] is True
