"""The proof mesh on the card, fed from one thread a card.  Every test here
carries the ``cuda`` marker and skips where ``torch.cuda.is_available()``
is false.  On a machine with GPUs:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py

The mesh spans four cards where there are four, else names ``cuda:0`` four
times.

- a step batch of 4 x 8 lanes with two seeded invalid lanes gives, through
  the mesh's feed threads, the verdict, plonk_ok and fri_ok that
  ``verify_batch`` gives on each shard alone, and the same at the key's
  first call, which captures on the calling thread;
- the ``SpanTimer`` of a mesh call holds its host spans, a positive replay
  on each card's stream and its counts;
- ``verify_batch`` with no timer launches the kernels it launched before
  (the wrappers' counters at a key's first call), and a replay with a
  ``SpanTimer`` launches the same kernels as one without.
"""
import random

import numpy as np
import pytest
import torch

from plonky2_tpu_torch import verifier
from plonky2_tpu_torch.hash import poseidon_bn254 as pb
from plonky2_tpu_torch.kernels import launches
from plonky2_tpu_torch.parallel import mesh as pmesh
from plonky2_tpu_torch.proof import serde
from plonky2_tpu_torch.proof.fixtures import (corrupt_leaf,
                                              corrupt_wires_opening,
                                              load_fixture)
from plonky2_tpu_torch.utils.profiling import SpanTimer, device_kernels

pytestmark = pytest.mark.cuda
SHARDS, PER = 4, 8
OUTPUTS = ("verdict", "plonk_ok", "fri_ok")
# One step verification's launches of each wrapper under each
# Poseidon-BN254 setting (chip_smoke.py's per_verify("step", impl)); a
# key's first call runs verify_device twice, the warm-up and the capture.
STEP_LAUNCHES = {"poseidon_bn254": 0, "poseidon_bn254_cios": 0,
                 "poseidon_gl_transcript": 1, "poseidon_gl_pi_hash": 1,
                 "qe_horner": 8, "qe_powers": 2, "qe_inv": 7, "gl_mul": 16,
                 "gl_mul_const": 17, "qe_mul": 154, "coset_interp_scan": 1,
                 "fri_leaf_blocks": 1}
CHAINS = {"mxu": "merkle_chains_a", "cios": "merkle_chains_cios"}


@pytest.fixture(scope="module")
def devices():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = torch.cuda.device_count()
    return ([torch.device("cuda", i) for i in range(SHARDS)] if n >= SHARDS
            else [torch.device("cuda", 0)] * SHARDS)


@pytest.fixture(scope="module")
def step(devices):
    """The step spec and a batch of 32 lanes: the fixture's proof in each,
    but a bad opening and a bad leaf in two lanes drawn from a seed."""
    spec, raw, vraw = load_fixture("testdata/step")
    proofs = [serde.ingest_proof(spec, r, vraw) for r in
              (raw, corrupt_wires_opening(raw), corrupt_leaf(raw))]
    lanes = [0] * (SHARDS * PER)
    bad = random.Random(2**31 + 11).sample(range(len(lanes)), 2)
    lanes[bad[0]], lanes[bad[1]] = 1, 2
    batch = serde.stack_proofs([proofs[k] for k in lanes])
    return spec, batch, bad


def _shard(batch, k):
    return {name: v[k * PER:(k + 1) * PER] for name, v in batch.items()}


def test_feed_threads_give_each_shards_outputs(devices, step):
    spec, batch, bad = step
    verifier.compiled_verifier.cache_clear()
    mesh = pmesh.make_mesh(devices)
    first = pmesh.verify_batch_sharded(spec, batch, mesh, diagnostics=True)
    assert not mesh.feeds  # the first call captured on the calling thread
    out = pmesh.verify_batch_sharded(spec, batch, mesh, diagnostics=True)
    assert set(mesh.feeds) == set(devices)
    want = [verifier.verify_batch(spec, _shard(batch, k), device=devices[k],
                                  diagnostics=True) for k in range(SHARDS)]
    for name in OUTPUTS:
        expected = np.concatenate([w[name] for w in want])
        assert np.array_equal(out[name], expected), name
        assert np.array_equal(first[name], expected), name
    assert sorted(np.flatnonzero(~out["verdict"]).tolist()) == sorted(bad)
    assert not out["plonk_ok"][bad[0]] and out["plonk_ok"][bad[1]]
    assert not out["fri_ok"][bad[1]]


def test_span_timer_of_a_mesh_call(devices, step):
    spec, batch, _ = step
    mesh = pmesh.make_mesh(devices)
    pmesh.verify_batch_sharded(spec, batch, mesh)  # captured, if not yet
    timer = SpanTimer()
    out = pmesh.verify_batch_sharded(spec, batch, mesh, diagnostics=True,
                                     timer=timer)
    timings = timer.read()
    assert out["verdict"].shape == (SHARDS * PER,)
    for name in ("mesh.feed", "mesh.gather", "mesh.call"):
        assert timings[name] > 0, name
    assert timings["mesh.call"] >= timings["mesh.feed"] + timings[
        "mesh.gather"]
    for k in range(SHARDS):
        assert timings[f"mesh.replay.{k}"] > 0 and f"mesh.load.{k}" in timings
    entry = verifier.compiled_verifier(spec, PER, devices[0],
                                       pb.kernel_impl())
    assert (timings["mesh.shards"], timings["mesh.pad_lanes"],
            timings["mesh.bytes_in"]) == (SHARDS, 0, SHARDS * entry.bytes_in)


def test_timer_adds_no_kernel(devices, step):
    spec, batch, _ = step
    dev, part = devices[0], _shard(batch, 0)
    impl = pb.kernel_impl()
    verifier.compiled_verifier.cache_clear()
    launches.reset()
    verifier.verify_batch(spec, part, device=dev)
    want = {**STEP_LAUNCHES, CHAINS["mxu"]: 0, CHAINS["cios"]: 0}
    want[CHAINS[impl]] = 1
    assert launches.read() == {k: 2 * v for k, v in want.items()}
    entry = verifier.compiled_verifier(spec, PER, dev, impl)

    def replay(timer):
        def fn():
            entry.load(part)
            entry.replay(timer)
        return fn

    _, plain_events, _, plain = device_kernels(replay(None), dev)
    timer = SpanTimer()
    _, timed_events, _, timed = device_kernels(replay(timer), dev)
    assert ({k: n for k, (n, _) in timed.items()}
            == {k: n for k, (n, _) in plain.items()})
    assert timed_events == plain_events > 0
    assert timer.read()["replay"] > 0
