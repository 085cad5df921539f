"""The port's profiling module and stage probe: ``flops_report`` equals the
JAX package's key for key on both fixtures, and
``tools/profile_verify.profile_stages`` times every stage of one
verification on the CPU and returns the verifier's verdicts.  Counts are
integers, compared exactly."""
import json

import pytest
import torch

from plonky2_tpu.proof.spec import load_circuit_spec as jload_spec
from plonky2_tpu.utils.profiling import flops_report as jflops_report
from plonky2_tpu_torch.proof import serde
from plonky2_tpu_torch.proof.fixtures import load_fixture
from plonky2_tpu_torch.proof.spec import load_circuit_spec
from plonky2_tpu_torch.tools import profile_verify
from plonky2_tpu_torch.utils.profiling import StageTimer, flops_report

torch.set_num_threads(1)
STAGES = ["prepare", "pi_hash", "transcript", "challenges", "plonk", "fri",
          "verdict"]


@pytest.mark.parametrize("name", ["step", "decode_block"])
def test_flops_report_matches_jax(name):
    path = f"testdata/{name}/common_circuit_data.json"
    assert flops_report(load_circuit_spec(path)) == jflops_report(jload_spec(path))


def test_stage_timer_reports_each_stage():
    timer = StageTimer("cpu")
    with timer.stage("a"):
        pass
    with pytest.raises(KeyError):
        with timer.stage("b"):
            raise KeyError("b")
    out = json.loads(timer.report(extra=1))
    assert sorted(out) == ["a", "b", "extra"] and out["extra"] == 1
    assert all(out[k] >= 0 for k in "ab")


def test_profile_stages_on_cpu():
    spec, raw, vraw = load_fixture("testdata/decode_block")
    batch = serde.stack_proofs([serde.ingest_proof(spec, raw, vraw)])
    st = profile_verify.profile_stages(spec, batch, "cpu")
    assert st.pop("verdicts").tolist() == [True]
    assert list(st) == STAGES + ["total"]
    assert all(v >= 0 for v in st.values())
    assert st["total"] == pytest.approx(sum(st[k] for k in STAGES))


def test_profile_verify_needs_a_gpu_or_cpu_flag(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert profile_verify.main(["--circuit", "testdata/decode_block"]) != 0
    assert "--cpu" in capsys.readouterr().err
