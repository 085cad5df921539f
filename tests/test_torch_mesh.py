"""The port's proof mesh and proof x query mesh on CPU devices.

A mesh may name one device more than once, so a mesh of CPU entries stands
in for the JAX tests' virtual devices.  Tiny-spec dummy proofs (all invalid)
must give the port's unsharded ``verify_batch`` verdicts on an 8-entry mesh
and a (4, 2) mesh.  On a (2, 2) mesh the decode_block batch [valid, bad
opening, a leaf corrupted in the last query round, a proof that fails
ingest] must give [True, False, False, False]: only the second query shard
sees lane 2's leaf, and only the ingest mask rejects lane 3, whose filler is
a copy of lane 0.  Lanes 0 to 2 must agree with the JAX package's
Python-int verifier (``bench.cpu_reference``).  Verdicts are booleans,
compared exactly."""
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

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _tiny_batch(n, rounds=4):
    spec = make_tiny_spec(rounds)
    return spec, serde.stack_proofs([make_dummy_proof(spec, seed=i)
                                     for i in range(n)])


@pytest.fixture(scope="module")
def tiny():
    spec, batch = _tiny_batch(8)
    return spec, batch, verifier.verify_batch(spec, batch, device="cpu")


@pytest.fixture(scope="module")
def decode_block_2x2():
    spec, raws, vraw = query_shard_lanes()
    batch, mask, errors = serde.ingest_batch(spec, [(r, vraw) for r in raws])
    assert mask.tolist() == [True, True, True, False] and list(errors) == [3]
    mesh = pmesh.make_mesh_2d([CPU] * 4, (2, 2))
    out = pmesh.verify_batch_sharded_2d(spec, batch, mesh, diagnostics=True)
    return dict(raws=raws, vraw=vraw, out=out)


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
    assert unsharded.tolist() == [False] * 8
    mesh = pmesh.make_mesh([CPU] * 8)
    assert mesh.shape == {"proof": 8}
    got = pmesh.verify_batch_sharded(spec, batch, mesh)
    assert got.shape == (8,) and np.array_equal(got, unsharded)


def test_tiny_batch_on_4x2_mesh(tiny):
    spec, batch, unsharded = tiny
    mesh = pmesh.make_mesh_2d([CPU] * 8, (4, 2))
    assert mesh.shape == {"proof": 4, "query": 2}
    got = pmesh.verify_batch_sharded_2d(spec, batch, mesh)
    assert got.shape == (8,) and np.array_equal(got, unsharded)


def test_decode_block_on_2x2_mesh(decode_block_2x2):
    out = decode_block_2x2["out"]
    assert out["verdict"].tolist() == [True, False, False, False]
    shards = out["query_shards"].tolist()
    assert shards[0] == [True, True]
    assert shards[1] == [False, False]      # PLONK: every shard rejects
    assert shards[2] == [True, False]       # the last round's leaf
    assert shards[3] == [True, True]        # filler: the ingest mask alone


def test_decode_block_on_2x2_mesh_matches_cpu_reference(decode_block_2x2):
    jspec = jload_spec("testdata/decode_block/common_circuit_data.json")
    ref = [bool(R.verify(jspec, r, decode_block_2x2["vraw"]))
           for r in decode_block_2x2["raws"][:3]]
    assert ref == [True, False, False]
    assert decode_block_2x2["out"]["verdict"][:3].tolist() == ref


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
