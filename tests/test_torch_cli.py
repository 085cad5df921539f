"""The port's command line against the JAX package's: ``inspect`` prints
the JAX ``flops_report`` plus the gates; ``verify --cpu`` verifies the
decode_block fixture and ``--out`` saves the same report line; without
``--cpu`` and without a GPU it exits non-zero.  Reports are compared
exactly."""
import json

import pytest
import torch

from plonky2_tpu.proof.spec import load_circuit_spec as jload_spec
from plonky2_tpu.utils.profiling import flops_report as jflops_report
from plonky2_tpu_torch import cli

torch.set_num_threads(1)
DB = "testdata/decode_block"


@pytest.mark.parametrize("name", ["step", "decode_block"])
def test_inspect_matches_jax(name, capsys):
    assert cli.main(["inspect", "--circuit", f"testdata/{name}"]) == 0
    got = json.loads(capsys.readouterr().out)
    jspec = jload_spec(f"testdata/{name}/common_circuit_data.json")
    want = jflops_report(jspec)
    want["gates"] = list(jspec.gate_ids)
    assert got == want


def test_verify_on_cpu_and_out_file(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = cli.main(["verify", "--cpu", "--circuit", DB, "--batch", "2",
                   "--out", str(out)])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == 0
    report = json.loads(printed)
    assert report["all_valid"] and report["verdicts"] == [1, 1]
    assert report["device"] == "cpu" and report["batch"] == 2
    assert out.read_text() == printed + "\n"


@pytest.mark.parametrize("command", ["verify", "bench"])
def test_no_gpu_without_cpu_flag_exits_nonzero(command, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert cli.main([command, "--circuit", DB, "--batch", "1"]) != 0
    assert "--cpu" in capsys.readouterr().err
