"""The port's two measurement tools on the CPU: ``tools/micro_pb`` (both
Poseidon-BN254 settings must give the same chain output) and
``tools/scaling_bench --cpu --tiny``, whose JSON goes to ``--out`` and
nowhere else; its process point starts a rank through
``tools/dist_worker.launch``, which names its files with ``mkstemp``.  On
the CPU they time the harness, not a device.  Without a GPU and without
``--cpu`` each exits non-zero."""
import json

import pytest
import torch

from plonky2_tpu_torch.tools import micro_pb, scaling_bench

torch.set_num_threads(1)


@pytest.mark.parametrize("tool", [micro_pb, scaling_bench],
                         ids=["micro_pb", "scaling_bench"])
def test_no_gpu_without_cpu_flag_exits_nonzero(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert tool.main([]) != 0
    assert "--cpu" in capsys.readouterr().err


def test_micro_pb_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(micro_pb, "STEPS", (1, 2))  # the plain chains are
    monkeypatch.setattr(micro_pb, "REPS", 1)        # slow on the CPU
    out = tmp_path / "micro_pb.json"
    assert micro_pb.main(["--cpu", "--lanes", "2", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == report
    assert report["device"] == "cpu" and report["lanes"] == 2
    assert report["steps"] == [1, 2]
    assert sorted(report["impls"]) == ["cios", "mxu"]


def test_scaling_bench_cpu_tiny_writes_json(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "scaling.json"
    assert scaling_bench.main(["--cpu", "--tiny", "--sizes", "1",
                               "--processes", "1", "--batch", "1",
                               "--iters", "1", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == report
    assert sorted(p.name for p in tmp_path.iterdir()) == ["scaling.json"]
    assert report["device"] == "cpu" and "caveat" in report
    (mesh,), (procs,) = report["mesh"], report["processes"]
    assert mesh["n"] == 1 and mesh["proofs_per_s"] > 0
    assert mesh["efficiency_vs_1"] == 1.0
    assert procs["n"] == 1 and procs["backend"] == "gloo"
    assert procs["proofs_per_s"] > 0
