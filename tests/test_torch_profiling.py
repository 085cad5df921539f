"""The port's profiling module and stage probe: ``flops_report`` equals the
JAX package's key for key on both fixtures;
``tools/profile_verify.profile_stages`` times every stage of one
verification on the CPU and returns the verifier's verdicts, quarantined
lanes False; the probe's phases (``transcript_phase``, ``plonk_phase``,
``fri_phase``) give ``verify_device``'s plonk_ok and fri_ok and the JAX
package's challenges, and its ``phases`` and ``replayed`` modes run on the
CPU (eagerly, ``"compiled": false``) on two tiny-spec proofs; the timer
that ``prepare``, ``verify_on_device`` and the compiled verifier take
changes none of their results.  Counts, verdicts and challenges are
integers, compared exactly."""
import contextlib
import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_tpu import verifier as jverifier
from plonky2_tpu.proof.spec import load_circuit_spec as jload_spec
from plonky2_tpu.proof.synthetic import make_tiny_spec as jmake_tiny_spec
from plonky2_tpu.transcript import challenger as jchal
from plonky2_tpu.utils.profiling import flops_report as jflops_report
from plonky2_tpu_torch import verifier
from plonky2_tpu_torch.proof import serde
from plonky2_tpu_torch.proof.fixtures import load_fixture
from plonky2_tpu_torch.proof.spec import load_circuit_spec
from plonky2_tpu_torch.proof.synthetic import make_dummy_proof, make_tiny_spec
from plonky2_tpu_torch.tools import profile_verify
from plonky2_tpu_torch.utils.profiling import StageTimer, flops_report

torch.set_num_threads(1)
STAGES = ["prepare", "pi_hash", "transcript", "challenges", "plonk", "fri",
          "verdict"]
REPLAYED_STAGES_CPU = ["observed", "convert", "pi_hash", "transcript",
                       "challenges", "plonk", "fri", "read_back", "mask"]


@pytest.fixture(scope="module")
def tiny():
    """The tiny spec and a batch of two dummy proofs (both invalid)."""
    spec = make_tiny_spec()
    return spec, serde.stack_proofs([make_dummy_proof(spec, seed=s)
                                     for s in range(2)])


@pytest.fixture(scope="module")
def tiny_phases(tiny):
    return profile_verify.profile_phases(*tiny, "cpu", reps=1)


@pytest.fixture(scope="module")
def tiny_verified(tiny_phases):
    """``verify_device(..., diagnostics=True)``'s outputs, from the probe's
    own run of it on the phases' tensors (the whole verifier, eager on the
    CPU)."""
    return tiny_phases["outputs"]["verifier"]


@pytest.fixture(scope="module")
def tiny_replayed(tiny):
    return profile_verify.profile_replayed(*tiny, "cpu", reps=1)


def _flat(tree):
    """A nest of dicts, lists and tuples of tensors or arrays -> int64
    numpy arrays in a fixed order."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for x in tree for a in _flat(x)]
    return [np.asarray(tree).astype(np.int64)]


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


def test_profile_stages_applies_the_ingest_mask(monkeypatch):
    """A lane that ``ingest_batch`` quarantined (and filled with a copy of
    the valid proof) reads False, as in ``verify_batch``, though the device
    stages (replaced here by an all-True stub, to stay fast) accept it."""
    spec, raw, vraw = load_fixture("testdata/decode_block")
    truncated = copy.deepcopy(raw)
    truncated["proof"]["openings"]["wires"] = \
        truncated["proof"]["openings"]["wires"][:-1]
    batch, mask, _ = serde.ingest_batch(
        spec, [(raw, vraw), (truncated, vraw), (raw, vraw)])
    assert mask.tolist() == [True, False, True]

    def all_true(spec, schedule, dev, obs, diagnostics=False, timer=None,
                 query_shard=None):
        ok = torch.ones((obs[0].shape[0],), dtype=torch.bool)
        return {"verdict": ok, "plonk_ok": ok, "fri_ok": ok} if diagnostics else ok

    monkeypatch.setattr(verifier, "verify_device", all_true)
    st = profile_verify.profile_stages(spec, batch, "cpu")
    assert st.pop("verdicts").tolist() == [True, False, True]
    assert verifier.verify_batch(spec, batch, device="cpu").tolist() == \
        [True, False, True]


def test_profile_verify_needs_a_gpu_or_cpu_flag(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert profile_verify.main(["--circuit", "testdata/decode_block"]) != 0
    assert "--cpu" in capsys.readouterr().err


def test_phases_give_verify_devices_plonk_and_fri(tiny_phases, tiny_verified):
    out = tiny_phases["outputs"]
    assert out["plonk_ok"].dtype == out["fri_ok"].dtype == np.bool_
    assert out["plonk_ok"].tolist() == tiny_verified["plonk_ok"].tolist()
    assert out["fri_ok"].tolist() == tiny_verified["fri_ok"].tolist()


def test_phases_report_on_cpu(tiny_phases):
    r = tiny_phases
    assert r["compiled"] is False
    assert list(r["phases"]) == ["transcript", "plonk", "fri"]
    for times in list(r["phases"].values()) + [r["whole"]]:
        assert sorted(times) == ["best_s", "median_s", "replay_s"]
        assert len(times["replay_s"]) == 1 and times["best_s"] > 0
    best = {k: v["best_s"] for k, v in r["phases"].items()}
    assert r["plonk_only_s"] == best["plonk"] - best["transcript"]
    assert r["fri_only_s"] == best["fri"] - best["transcript"]


def test_transcript_phase_matches_jax_challenges(tiny, tiny_phases):
    """The port's transcript phase (its output in the probe's run) against
    the JAX package's ``_extract_challenges(schedule, run_transcript(...))``
    on the same proofs, the JAX transcript run as its CPU tests run it (the
    jnp scan).  The JAX transcript takes the port's public-input hash,
    which ``test_torch_scan_kernels.py`` holds against the JAX hash."""
    spec, batch = tiny
    pi_hash, challenges = tiny_phases["outputs"]["transcript"]

    def jsplit(arr):
        arr = np.asarray(arr, dtype=np.uint64)
        return (jnp.asarray((arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
                jnp.asarray((arr >> np.uint64(32)).astype(np.uint32)))

    jspec = jmake_tiny_spec()
    jschedule = jchal.build_schedule(jspec)
    jpi_hash = tuple(jnp.asarray(h.astype(np.uint32)) for h in pi_hash)
    states = jchal.run_transcript(
        jschedule, jsplit(jchal.build_observed_host(jspec, batch)), jpi_hash)
    want = jverifier._extract_challenges(jschedule, states)
    assert sorted(challenges) == sorted(want)
    got, want = _flat(challenges), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_replayed_stages_on_cpu(tiny_replayed, tiny_verified):
    r = tiny_replayed
    assert r["compiled"] is False
    assert list(r["stages"]) == REPLAYED_STAGES_CPU
    assert r["stage_sum_s"] == pytest.approx(sum(r["stages"].values()))
    assert len(r["unprobed_s"]) == 1 and r["unprobed_median_s"] > 0
    assert r["verdicts"].tolist() == r["unprobed_verdicts"].tolist() == \
        tiny_verified["verdict"].tolist()


def test_prepare_with_a_timer_gives_the_same_tensors(tiny):
    spec, batch = tiny
    timer = StageTimer("cpu")
    plain = verifier.prepare(spec, batch, "cpu")
    timed = verifier.prepare(spec, batch, "cpu", timer)
    assert list(timer.timings) == ["observed", "convert"]
    assert plain[0] is timed[0]
    for a, b in zip(_flat(plain[1:]), _flat(timed[1:])):
        assert np.array_equal(a, b)


class _ReplayedByRunning:
    """A stand-in for a CUDA graph on the CPU: a replay runs ``fn`` again
    and writes into the first run's outputs, as a graph's replay does."""

    def __init__(self, fn):
        self.fn, self.outputs = fn, fn()

    def replay(self):
        for k, v in self.fn().items():
            self.outputs[k].copy_(v)


def test_compiled_verifier_with_and_without_a_timer(monkeypatch, tiny):
    """The compiled verifier's plumbing on the CPU (the graph and the
    verification replaced by stand-ins, to stay fast): one capture at the
    first call, re-fed inputs give their own outputs, the outputs are
    clones; a timer adds the stages copy_in, replay and outputs and changes
    no result; a malformed batch raises with or without it."""
    spec, batch = tiny
    captures = []

    def capture(fn, device):
        captures.append(device)
        graph = _ReplayedByRunning(fn)
        return graph, graph.outputs, 0.0, 0.0

    def lane_parity(spec, schedule, dev, obs, diagnostics=False, timer=None,
                    query_shard=None):
        ok = (obs[0][:, 0] & 1) == 0
        return {"verdict": ok & ~ok, "plonk_ok": ok, "fri_ok": ~ok}

    monkeypatch.setattr(verifier, "capture", capture)
    monkeypatch.setattr(verifier, "verify_device", lane_parity)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    entry = verifier.CompiledVerifier(spec, 2, "cpu", "mxu")
    _, dev, obs = verifier.prepare(spec, batch, "cpu", narrow=True)
    want = {k: v.tolist() for k, v in lane_parity(
        spec, None, dev, obs).items()}
    first = entry(dev, obs)
    timer = StageTimer("cpu")
    again = entry(dev, obs, timer)
    assert len(captures) == 1
    assert list(timer.timings) == ["copy_in", "replay", "outputs"]
    for out in (first, again):
        assert {k: v.tolist() for k, v in out.items()} == want
        assert all(out[k] is not entry.outputs[k] for k in out)
    flipped = (obs[0] ^ 1, obs[1])
    got = entry(dev, flipped, StageTimer("cpu"))
    assert got["plonk_ok"].tolist() == [not x for x in want["plonk_ok"]]
    qkeys = serde.query_axis_keys(spec)
    _, no_rounds, _ = verifier.prepare(spec, {
        k: (v[:, :0] if k in qkeys else v) for k, v in batch.items()}, "cpu",
        narrow=True)
    for t in (None, StageTimer("cpu")):
        with pytest.raises(ValueError, match="query rounds"):
            entry(no_rounds, obs, t)


@pytest.mark.parametrize("mode", profile_verify.MODES)
def test_profile_verify_mode_prints_json(monkeypatch, capsys, tiny,
                                         tiny_phases, tiny_replayed, mode):
    """``--mode`` on the CPU: one JSON line a repetition, marked
    ``"compiled": false``, with the mode's keys; the tiny proofs are
    invalid, so the run stops after the first line with exit code 1.  The
    probes' results come from the module fixtures (``stages`` from a stub:
    ``profile_stages`` has its own tests above)."""
    monkeypatch.setattr(profile_verify, "load_batch", lambda c, n: tiny)
    monkeypatch.setattr(profile_verify, "profile_phases",
                        lambda *a: copy.deepcopy(tiny_phases))
    monkeypatch.setattr(profile_verify, "profile_replayed",
                        lambda *a: copy.deepcopy(tiny_replayed))
    monkeypatch.setattr(profile_verify, "profile_stages", lambda *a: dict(
        {k: 0.0 for k in STAGES}, total=0.0, verdicts=np.zeros(2, bool)))
    rc = profile_verify.main(["--cpu", "--mode", mode, "--batch", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 1 and len(lines) == 1
    line = json.loads(lines[0])
    assert line["mode"] == mode and line["compiled"] is False
    assert line["all_valid"] is False and line["device"] == "cpu"
    keys = {"phases": ["phases", "whole", "plonk_only_s", "fri_only_s"],
            "replayed": ["stages", "stage_sum_s", "unprobed_median_s"],
            "stages": ["seconds"]}[mode]
    assert all(k in line for k in keys)
    assert "outputs" not in line and "verdicts" not in line


@pytest.mark.parametrize("mode", profile_verify.MODES)
def test_profile_verify_modes_exit_2_without_a_gpu(capsys, mode):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert profile_verify.main(["--circuit", "testdata/decode_block",
                                "--mode", mode]) == 2
    assert "--cpu" in capsys.readouterr().err
