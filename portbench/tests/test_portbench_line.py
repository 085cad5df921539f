"""A run's last line, and ``correct`` against a timed path broken
underneath: the harness's look for a chip is skipped and the plain
reference stands in for the system, with each fault the cells can have
planted in what it returns."""

import json
import subprocess
import sys

import numpy as np
import pytest

from portbench.harness import catalog, control, main

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


class Faulty(control.ReferenceSystem):
    """The reference's answers with one fault where they are produced:
    ``stale``, a call that returns the last call's outputs (its state
    unchanged); ``half``, the second half of the batch left out (its lanes
    copied from the first half's); ``accept``, one invalid lane accepted;
    ``flip``, one lane's fri_ok flipped."""

    def __init__(self, circuit_dir, fault):
        super().__init__(circuit_dir)
        self.fault, self.last = fault, None

    def verify(self, i):
        out = super().verify(i)
        if self.fault == "stale":
            out, self.last = (self.last or out), out
        elif self.fault == "half":
            half = len(out["verdict"]) // 2
            for v in out.values():
                v[half:] = np.resize(v[:half], len(v) - half)
        elif self.fault == "accept":
            bad = np.flatnonzero(~out["verdict"])
            if bad.size:
                out["verdict"][bad[0]] = True
        elif self.fault == "flip":
            out["fri_ok"][0] = ~out["fri_ok"][0]
        return out


def _run(cell, system, seconds=0.2, trace=0, seed=2**31 + 17):
    args = main.parse(["--workload", cell, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)])
    result, notes = main.run_cell(args, 0.0, system_factory=system,
                                  chip_check=control.no_chip_check)
    assert set(notes) == {"setup_s by phase", "window"}
    return result


def test_line_keys(cached_reference):
    result = _run("decode_block-b4", lambda d: control.ReferenceSystem(d))
    assert list(result) == KEYS + ["checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0 and result["attempted"] % 4 == 0
    assert set(result["metrics"]) == {"batch_p95_ms", "setup_s"}
    assert result["device"]["platform"] == "gpu"
    for c in result["checks"].values():
        assert c == {"value": 0, "limit": 0}
    json.dumps(result)


@pytest.mark.parametrize("fault", ["stale", "half", "accept", "flip"])
@pytest.mark.parametrize("cell", ["decode_block-b4", "step-b64"])
def test_fault_is_not_correct(cell, fault, cached_reference):
    result = _run(cell, lambda d: Faulty(d, fault))
    assert result["correct"] is False
    assert result["failed"] > 0
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_accepted_invalid_lane_in_one_call(cached_reference):
    """One wrong verdict bit in one call of the window is enough."""
    class Once(control.ReferenceSystem):
        calls = 0

        def verify(self, i):
            out = super().verify(i)
            Once.calls += 1
            if Once.calls == 20 and not out["verdict"].all():
                out["verdict"][:] = True
            elif Once.calls == 20:
                Once.calls -= 1
            return out

    result = _run("decode_block-b4", Once)
    assert result["correct"] is False
    assert result["checks"]["verdict_lanes_wrong"]["value"] == 1
    assert result["checks"]["plonk_ok_lanes_wrong"]["value"] == 0


def test_no_card_exits_nonzero_without_a_result():
    """Without a CUDA device run.py prints nothing on standard output and
    exits non-zero."""
    proc = subprocess.run(
        [sys.executable, str(catalog.BENCH_DIR / "run.py"), "--workload",
         "decode_block-b4", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=catalog.ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "memory_peak_bytes" not in proc.stderr


def test_alone_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, the run
    fails and prints no result."""
    import shutil

    shutil.copy(catalog.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(catalog.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "step-b64",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


def test_forbidden_modules_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "plonky2_tpu_torch_x", sys)
    assert main.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "plonky2_tpu.verifier", sys)
    assert main.forbidden_modules() == ["plonky2_tpu"]


def test_p95_nearest_rank():
    assert main.p95(list(range(1, 101))) == 95
    assert main.p95([3.0]) == 3.0
    assert main.p95(list(range(1, 21))) == 19


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    def __init__(self, name, device, start, end):
        from torch.autograd import DeviceType

        self.name = name
        self.device_type = getattr(DeviceType, device)
        self.time_range = _Range(start, end)


def test_stretch_on_the_trace_clock():
    """The stretch runs from the second call's span to the end of the
    last; device work of the first call is left out, and idle is the
    stretch's length less the union of its device intervals."""
    from portbench.harness import readers, trace

    span = trace.CALL_SPAN
    events = [
        _Event(span, "CPU", 0, 900), _Event("k", "CUDA", 100, 800),
        _Event(span, "CPU", 1000, 2000), _Event("k", "CUDA", 1100, 1500),
        _Event("Memcpy HtoD", "CUDA", 1400, 1600),
        _Event("cudaGraphLaunch", "CPU", 1600, 1990),
        _Event(span, "CPU", 2000, 3000), _Event("k", "CUDA", 2000, 2020),
        _Event("k", "CUDA", 2500, 2900),
        _Event("Buffer Flush", "CPU", 2030, 2400),
    ]
    summary = trace.reduce_events(events)
    assert summary["calls"] == 2
    assert summary["window_s"] == pytest.approx(2000e-6)
    assert summary["busy_s"] == pytest.approx(920e-6)
    assert summary["kernels"]["k"] == (3, pytest.approx(820e-6))
    assert summary["copy_events"] == 1
    assert summary["call_ms"] == [pytest.approx(1.0), pytest.approx(1.0)]
    assert summary["gaps"] == {
        "verify_batch (python, numpy)": pytest.approx(200e-6),
        "cudaGraphLaunch": pytest.approx(400e-6),
        "Buffer Flush": pytest.approx(480e-6)}

    class Run:
        profile = summary

    assert readers.idle_pct(Run) == pytest.approx(54.0)
    assert trace.reduce_events(events[:2]) is None
