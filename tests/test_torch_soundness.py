"""The port's soundness matrix against ``tools/soundness_matrix.py``: the
same corruption cases (names and mutated JSON), and the whole decode_block
matrix verified in one ``verify_batch(..., device="cpu")`` call, with lane 0
True and every other lane False.  Verdicts are booleans, compared
exactly."""
import importlib.util
import os

import pytest
import torch

from plonky2_tpu_torch.proof.fixtures import load_fixture
from plonky2_tpu_torch.tools import soundness_matrix

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "soundness_matrix", os.path.join(ROOT, "tools/soundness_matrix.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_cases_match_the_jax_tool():
    jtool = _jax_tool()
    for fixture in ("decode_block", "step"):
        _, raw, vraw = load_fixture(f"{ROOT}/testdata/{fixture}")
        got = soundness_matrix.build_cases(raw, vraw)
        want = jtool.build_cases(raw, vraw)
        assert [c[0] for c in got] == [c[0] for c in want]
        assert got == want
        assert len({c[0] for c in got}) == len(got)


def test_decode_block_matrix_on_cpu():
    out = soundness_matrix.run("decode_block", "cpu")
    verdicts = [r["verdict"] for r in out["rows"]]
    assert out["lanes"] == len(verdicts) == 20  # no public inputs
    assert verdicts == [True] + [False] * 19
    assert out["all_correct"] and out["device"] == "cpu"
    assert out["metric"] == "soundness_matrix" and out["fixture"] == "decode_block"


def test_main_needs_a_gpu_or_cpu_flag(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert soundness_matrix.main(["--fixture", "decode_block"]) != 0
    assert "--cpu" in capsys.readouterr().err
