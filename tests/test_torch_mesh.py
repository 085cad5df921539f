"""The port's proof mesh and proof x query mesh on CPU devices.

A mesh may name one device more than once, so a mesh of CPU entries stands
in for the JAX tests' virtual devices.  Tiny-spec dummy proofs (all invalid)
must give the port's unsharded ``verify_batch`` verdicts on an 8-entry mesh
and a (4, 2) mesh.  On a (2, 2) mesh the decode_block batch [valid, bad
opening, a leaf corrupted in the last query round, a proof that fails
ingest] must give [True, False, False, False]: only the second query shard
sees lane 2's leaf, and only the ingest mask rejects lane 3, whose filler is
a copy of lane 0.  Lanes 0 to 2 must agree with the JAX package's
Python-int verifier (``bench.cpu_reference``).  With diagnostics, both
meshes give the unsharded ``verify_batch``'s verdict, plonk_ok and fri_ok
lane for lane.  The feed threads, driven with stand-in CPU entries, give
the calling thread's outputs in lane order; a malformed shard raises before
any shard is loaded, and an error on a feed thread reaches the caller and
leaves the threads free.  Verdicts are booleans, compared exactly."""
import itertools
import sys
import threading

import numpy as np
import pytest
import torch

from plonky2_tpu.bench import cpu_reference as R
from plonky2_tpu.parallel import mesh as jmesh
from plonky2_tpu.proof.spec import load_circuit_spec as jload_spec
from plonky2_tpu_torch import verifier
from plonky2_tpu_torch.fri.verify import query_rounds, verify_fri
from plonky2_tpu_torch.parallel import mesh as pmesh
from plonky2_tpu_torch.proof import serde
from plonky2_tpu_torch.proof.fixtures import query_shard_lanes
from plonky2_tpu_torch.proof.synthetic import make_dummy_proof, make_tiny_spec
from plonky2_tpu_torch.utils.profiling import SpanTimer

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _tiny_batch(n, rounds=4):
    spec = make_tiny_spec(rounds)
    return spec, serde.stack_proofs([make_dummy_proof(spec, seed=i)
                                     for i in range(n)])


@pytest.fixture(scope="module")
def tiny():
    spec, batch = _tiny_batch(8)
    return spec, batch, verifier.verify_batch(spec, batch, device="cpu",
                                              diagnostics=True)


@pytest.fixture(scope="module")
def decode_block_2x2():
    spec, raws, vraw = query_shard_lanes()
    batch, mask, errors = serde.ingest_batch(spec, [(r, vraw) for r in raws])
    assert mask.tolist() == [True, True, True, False] and list(errors) == [3]
    mesh = pmesh.make_mesh_2d([CPU] * 4, (2, 2))
    out = pmesh.verify_batch_sharded_2d(spec, batch, mesh, diagnostics=True)
    unsharded = verifier.verify_batch(spec, batch, device="cpu",
                                      diagnostics=True)
    return dict(raws=raws, vraw=vraw, out=out, unsharded=unsharded)


@pytest.fixture(scope="module")
def decode_block_reference(decode_block_2x2):
    """The JAX package's Python-int verdicts of lanes 0 to 2."""
    jspec = jload_spec("testdata/decode_block/common_circuit_data.json")
    return [bool(R.verify(jspec, r, decode_block_2x2["vraw"]))
            for r in decode_block_2x2["raws"][:3]]


@pytest.mark.parametrize("n, multiple", [(5, 8), (5, 5), (3, 2)])
def test_pad_batch_matches_jax(n, multiple):
    _, batch = _tiny_batch(n, rounds=1)
    got, real = pmesh.pad_batch(batch, multiple)
    want, jreal = jmesh.pad_batch(batch, multiple)
    assert real == jreal == n
    assert (got is batch) == (want is batch) == (n % multiple == 0)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
        assert (got[k][n:] == got[k][:1]).all(), k


def test_tiny_batch_on_8_entry_mesh(tiny):
    spec, batch, unsharded = tiny
    assert unsharded["verdict"].tolist() == [False] * 8
    mesh = pmesh.make_mesh([CPU] * 8)
    assert mesh.shape == {"proof": 8}
    got = pmesh.verify_batch_sharded(spec, batch, mesh, diagnostics=True)
    assert sorted(got) == sorted(unsharded)
    for name, want in unsharded.items():
        assert got[name].shape == (8,) and np.array_equal(got[name], want)


def test_tiny_batch_on_4x2_mesh(tiny):
    spec, batch, unsharded = tiny
    mesh = pmesh.make_mesh_2d([CPU] * 8, (4, 2))
    assert mesh.shape == {"proof": 4, "query": 2}
    got = pmesh.verify_batch_sharded_2d(spec, batch, mesh)
    assert got.shape == (8,) and np.array_equal(got, unsharded["verdict"])


def test_decode_block_on_2x2_mesh(decode_block_2x2):
    out = decode_block_2x2["out"]
    assert out["verdict"].tolist() == [True, False, False, False]
    shards = out["query_shards"].tolist()
    assert shards[0] == [True, True]
    assert shards[1] == [False, False]      # PLONK: every shard rejects
    assert shards[2] == [True, False]       # the last round's leaf
    assert shards[3] == [True, True]        # filler: the ingest mask alone


def test_decode_block_on_2x2_mesh_matches_cpu_reference(
        decode_block_2x2, decode_block_reference):
    ref = decode_block_reference
    assert ref == [True, False, False]
    assert decode_block_2x2["out"]["verdict"][:3].tolist() == ref


def test_decode_block_2x2_diagnostics_match_verify_batch(
        decode_block_2x2, decode_block_reference):
    """On a mesh that names the CPU four times, every output of every lane
    is the unsharded verifier's: plonk_ok the PLONK check that each query
    shard repeats, fri_ok the AND of the query shards' FRI checks."""
    out, want = decode_block_2x2["out"], decode_block_2x2["unsharded"]
    for name in ("verdict", "plonk_ok", "fri_ok"):
        assert out[name].shape == (4,), name
        assert np.array_equal(out[name], want[name]), name
    assert out["verdict"][:3].tolist() == decode_block_reference
    # the leaf of lane 2 fails FRI alone; the filler, lane 3, fails ingest
    assert out["plonk_ok"].tolist() == [True, False, True, True]
    assert out["fri_ok"].tolist() == [True, False, False, True]


@pytest.mark.parametrize("n_query", [3, 5, 8])
def test_query_shard_count_must_divide_the_rounds(n_query):
    spec, batch = _tiny_batch(2)
    with pytest.raises(ValueError, match="query shard"):
        query_rounds(spec, (0, n_query))
    mesh = pmesh.make_mesh_2d([CPU] * n_query, (1, n_query))
    with pytest.raises(ValueError, match="query shard"):
        pmesh.verify_batch_sharded_2d(spec, batch, mesh)


def test_query_rounds_are_contiguous_blocks():
    spec = make_tiny_spec(4)
    assert [query_rounds(spec, (k, 2)) for k in range(2)] == [(0, 2), (2, 4)]
    assert query_rounds(spec) == (0, 4) == query_rounds(spec, (0, 1))


def test_query_sharded_batch_needs_its_query_shard():
    """A batch holding Q/2 rounds is malformed unless a query shard says
    so, and a query shard takes no batch of another count."""
    spec, batch = _tiny_batch(2)
    half = set(serde.query_axis_keys(spec))
    cut = {k: (v[:, :2] if k in half else v) for k, v in batch.items()}
    for dev, shard in [(cut, None), (batch, (0, 2)), (cut, (0, 4))]:
        with pytest.raises(ValueError, match="query rounds"):
            verify_fri(spec, verifier.proof_to_device(dev, "cpu"),
                       challenges=None, verdict=None, query_shard=shard)


def _accept_all(spec, schedule, dev, obs, diagnostics=False, timer=None,
                query_shard=None):
    ok = torch.ones(obs[0].shape[0], dtype=torch.bool)
    return {"verdict": ok, "plonk_ok": ok, "fri_ok": ok} if diagnostics else ok


@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
def test_masks_reach_the_sharded_paths(monkeypatch, two_d):
    """Both masks apply on the mesh paths: the batch's ingest mask and the
    caller's ``valid_mask``.  The device verdict is stubbed to all True so
    that only the masks can make a lane False."""
    monkeypatch.setattr(verifier, "verify_device", _accept_all)
    spec, batch = _tiny_batch(5)
    batch[serde.VALID_MASK] = np.asarray([True, False, True, True, True])
    valid = np.asarray([True, True, True, False, True])
    if two_d:
        mesh = pmesh.make_mesh_2d([CPU] * 4, (2, 2))
        run = pmesh.verify_batch_sharded_2d
    else:
        mesh = pmesh.make_mesh([CPU] * 3)
        run = pmesh.verify_batch_sharded
    assert run(spec, batch, mesh).tolist() == [True, False, True, True, True]
    assert run(spec, batch, mesh, valid_mask=valid).tolist() == \
        [True, False, True, False, True]


def test_meshes_need_a_gpu_unless_given_cpu_devices():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for make in (pmesh.make_mesh, pmesh.make_mesh_2d):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(["cuda:0"])


def _by_query_shard(plonk):
    """A stand-in ``verify_device`` whose plonk_ok is ``plonk(query
    shard)`` and fri_ok True."""
    def verify_device(spec, schedule, dev, obs, diagnostics=False,
                      timer=None, query_shard=None):
        B = obs[0].shape[0]
        ok = torch.ones(B, dtype=torch.bool)
        plonk_ok = torch.full((B,), plonk(query_shard), dtype=torch.bool)
        return {"verdict": plonk_ok, "plonk_ok": plonk_ok, "fri_ok": ok}
    return verify_device


def test_query_shards_must_agree_on_plonk(monkeypatch):
    spec, batch = _tiny_batch(4)
    mesh = pmesh.make_mesh_2d([CPU] * 4, (2, 2))
    monkeypatch.setattr(verifier, "verify_device",
                        _by_query_shard(lambda shard: True))
    out = pmesh.verify_batch_sharded_2d(spec, batch, mesh, diagnostics=True)
    assert out["plonk_ok"].tolist() == out["verdict"].tolist() == [True] * 4
    monkeypatch.setattr(verifier, "verify_device",
                        _by_query_shard(lambda shard: shard[0] == 0))
    with pytest.raises(RuntimeError, match="disagree on the PLONK check"):
        pmesh.verify_batch_sharded_2d(spec, batch, mesh, diagnostics=True)


class _Recorder:
    """A stand-in shard entry on the CPU, on a feed of its own
    (``device``): its outputs are read from the lanes it was loaded with,
    so that each lane's are its own, and it logs each load with the thread
    that ran it."""

    bytes_in = 3
    graph = "captured"

    def __init__(self, device, log, fail=False):
        self.device, self.log, self.fail = device, log, fail

    def load(self, part, timer=None):
        if self.fail:
            raise RuntimeError("load failed")
        self.part = part
        self.log.append((self.device, threading.get_ident(),
                         part["pow_witness"].tolist()))

    def replay(self, timer=None):
        w = torch.from_numpy(self.part["pow_witness"].astype(np.int64))
        return {"verdict": w % 2 == 0, "plonk_ok": w % 3 == 0,
                "fri_ok": w % 5 != 0}


@pytest.fixture
def recorders(monkeypatch):
    """The mesh's entries replaced by ``_Recorder``s on two feeds, shards
    taking turns, run on the calling thread unless a test says otherwise;
    ``fail`` names shards whose load raises."""
    log, fail = [], set()
    count = itertools.count()

    def entry(spec, batch_size, device, query_shard):
        k = next(count)
        return _Recorder(("feed", k % 2), log, fail=k % 4 in fail)

    monkeypatch.setattr(pmesh, "_entry", entry)
    monkeypatch.setattr(pmesh, "_threaded", lambda entries: False)
    return log, fail


@pytest.mark.parametrize("threaded", [False, True],
                         ids=["calling_thread", "feed_threads"])
def test_feed_keeps_lane_order_and_padding(monkeypatch, recorders, threaded):
    log, _ = recorders
    monkeypatch.setattr(pmesh, "_threaded", lambda entries: threaded)
    spec, batch = _tiny_batch(5, rounds=1)
    batch["pow_witness"] = np.arange(5, dtype=batch["pow_witness"].dtype) + 7
    mesh = pmesh.make_mesh([CPU] * 4)
    timer = SpanTimer()
    out = pmesh.verify_batch_sharded(spec, batch, mesh, diagnostics=True,
                                     timer=timer)
    w = np.arange(5) + 7
    assert out["verdict"].tolist() == (w % 2 == 0).tolist()
    assert out["plonk_ok"].tolist() == (w % 3 == 0).tolist()
    assert out["fri_ok"].tolist() == (w % 5 != 0).tolist()
    # 8 lanes in 4 shards of 2, lanes 5 to 7 copies of lane 0; each feed
    # loads its shards in order
    shards = [[7, 8], [9, 10], [11, 7], [7, 7]]
    for d in (0, 1):
        assert [p for e, _, p in log if e == ("feed", d)] == shards[d::2]
    threads = {d: {t for e, t, _ in log if e == d} for d, _, _ in log}
    assert all(len(t) == 1 for t in threads.values())
    on_caller = {threading.get_ident()} == set().union(*threads.values())
    assert on_caller != threaded
    assert bool(mesh.feeds) == threaded
    timings = timer.read()
    assert {f"mesh.load.{k}" for k in range(4)} <= set(timings)
    assert {"mesh.feed", "mesh.gather", "mesh.call"} <= set(timings)
    assert timings["mesh.call"] >= timings["mesh.feed"] > 0
    assert (timings["mesh.shards"], timings["mesh.pad_lanes"],
            timings["mesh.bytes_in"]) == (4, 3, 12)


def test_malformed_shard_raises_before_any_load(recorders):
    log, _ = recorders
    spec, batch = _tiny_batch(8, rounds=1)
    mesh = pmesh.make_mesh([CPU] * 4)
    short = dict(batch, final_poly=batch["final_poly"][:7])  # shard 3: 1 lane
    with pytest.raises(ValueError, match="final_poly"):
        pmesh.verify_batch_sharded(spec, short, mesh)
    assert log == []
    assert pmesh.verify_batch_sharded(spec, batch, mesh).shape == (8,)


def test_feed_thread_error_reaches_the_caller(monkeypatch, recorders):
    log, fail = recorders
    monkeypatch.setattr(pmesh, "_threaded", lambda entries: True)
    spec, batch = _tiny_batch(8, rounds=1)
    mesh = pmesh.make_mesh([CPU] * 4)
    fail.add(2)
    with pytest.raises(RuntimeError, match="load failed"):
        pmesh.verify_batch_sharded(spec, batch, mesh)
    assert len(log) == 3  # the other shards ran to their end
    fail.clear()
    assert pmesh.verify_batch_sharded(spec, batch, mesh).shape == (8,)
    assert len(log) == 7 and len(mesh.feeds) == 2


def test_feed_threads_under_fast_switching(monkeypatch):
    """64 shards on 16 feed threads, more threads than cores, with the
    interpreter switching threads every microsecond: every shard's outputs
    and spans land, in lane order."""
    log = []
    count = itertools.count()
    monkeypatch.setattr(pmesh, "_entry", lambda *args: _Recorder(
        ("feed", next(count) % 16), log))
    monkeypatch.setattr(pmesh, "_threaded", lambda entries: True)
    spec, batch = _tiny_batch(1, rounds=1)
    batch = {k: np.repeat(v, 128, axis=0) for k, v in batch.items()}
    batch["pow_witness"] = np.arange(128, dtype=batch["pow_witness"].dtype)
    mesh = pmesh.make_mesh([CPU] * 64)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        timer = SpanTimer()
        out = pmesh.verify_batch_sharded(spec, batch, mesh, diagnostics=True,
                                         timer=timer)
    finally:
        sys.setswitchinterval(interval)
    assert out["verdict"].tolist() == (np.arange(128) % 2 == 0).tolist()
    assert len(log) == 64 and len(mesh.feeds) == 16
    assert {f"mesh.load.{k}" for k in range(64)} <= set(timer.read())
