"""The port's ``torch.distributed`` verifier on CPU ranks (gloo).

Two ranks as subprocesses (``tools/dist_worker.launch``, each with the
launcher's time limit): decode_block, the valid proof on rank 0 and the
bad-opening proof on rank 1.  Both ranks must report the verdicts that the
JAX package's two-process test pins, [True, False], equal to the JAX
package's Python-int verifier (``bench.cpu_reference``) on the same two
JSONs, and an accept count of 1.  The same ranks then pass local batches of
unequal size (1 and 2 lanes), and then rank 1 a batch with one query round
of the circuit's two; each must raise ``ValueError`` on every rank.
In this process, a group of world size 1 verifies both decode_block proofs
(the same verdicts again), verifies tiny-spec dummy proofs like
``verify_batch`` and applies both masks.  Verdicts are booleans, compared
exactly."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from plonky2_tpu.bench import cpu_reference as R
from plonky2_tpu.proof.spec import load_circuit_spec as jload_spec
from plonky2_tpu_torch import verifier
from plonky2_tpu_torch.parallel import distributed
from plonky2_tpu_torch.proof import serde
from plonky2_tpu_torch.proof.fixtures import corrupt_wires_opening, load_fixture
from plonky2_tpu_torch.proof.synthetic import make_dummy_proof, make_tiny_spec
from plonky2_tpu_torch.tools import dist_worker

torch.set_num_threads(1)
DECODE_BLOCK = "testdata/decode_block"


@pytest.fixture(scope="module")
def two_ranks():
    return dist_worker.launch(
        2, ["--device", "cpu", "--backend", "gloo",
            "--circuit", "testdata/decode_block", "--local-batch", "1",
            "--corrupt", "1", "--unequal-check"], timeout=300)


@pytest.fixture(scope="module")
def decode_block():
    """(spec, [valid, bad opening] JSONs, verifier-only JSON, the JAX
    package's Python-int verdicts on them): global lanes 0 and 1 of the
    two-rank job."""
    spec, raw, vraw = load_fixture(DECODE_BLOCK)
    raws = [raw, corrupt_wires_opening(raw)]
    jspec = jload_spec(f"{DECODE_BLOCK}/common_circuit_data.json")
    ref = [bool(R.verify(jspec, r, vraw)) for r in raws]
    assert ref == [True, False]
    return spec, raws, vraw, ref


@pytest.fixture(scope="module")
def world_of_one():
    distributed.initialize(
        "gloo", f"tcp://localhost:{dist_worker.free_port()}", 1, 0, "cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tiny(n):
    spec = make_tiny_spec()
    return spec, serde.stack_proofs([make_dummy_proof(spec, seed=i)
                                     for i in range(n)])


def test_two_gloo_ranks_agree_on_the_verdicts(two_ranks, decode_block):
    ref = decode_block[-1]
    for rank, r in enumerate(two_ranks):
        assert r["rank"] == rank and r["backend"] == "gloo"
        assert r["verdicts"] == ref, r
        assert r["n_accept"] == 1, r


def test_unequal_local_sizes_raise_on_every_rank(two_ranks):
    for r in two_ranks:
        assert r["unequal_error"] is not None, r
        assert "[1, 2]" in r["unequal_error"]


def test_wrong_query_round_count_raises_on_every_rank(two_ranks):
    """Rank 1 passes a batch with one query round of the circuit's two: the
    ranks gather a shape flag before verifying, so both raise (within the
    launcher's time limit) rather than rank 0 waiting in the verdict
    gather."""
    for r in two_ranks:
        assert r["query_round_error"] is not None, r
        assert "[True, False]" in r["query_round_error"]
    assert "init_leaves_0" in two_ranks[1]["query_round_error"]


def test_world_of_one_equals_verify_batch(world_of_one):
    spec, batch = _tiny(2)
    distributed.initialize(backend="nccl")  # already up: nothing happens
    assert dist.get_backend() == "gloo"
    verdicts, n_accept = distributed.verify_batch_distributed(spec, batch,
                                                              "cpu")
    want = verifier.verify_batch(spec, batch, device="cpu")
    assert verdicts.tolist() == want.tolist() == [False, False]
    assert n_accept == 0


def test_world_of_one_accepts_the_valid_proof(world_of_one, decode_block,
                                              two_ranks):
    spec, raws, vraw, ref = decode_block
    batch = serde.stack_proofs([serde.ingest_proof(spec, r, vraw)
                                for r in raws])
    verdicts, n_accept = distributed.verify_batch_distributed(spec, batch,
                                                              "cpu")
    assert verdicts.tolist() == ref == two_ranks[0]["verdicts"]
    assert n_accept == 1


def test_masks_reach_the_distributed_path(world_of_one, monkeypatch):
    """The batch's ingest mask and the caller's ``valid_mask`` both apply
    before the gather and the count; the device verdict is stubbed to all
    True so that only the masks can make a lane False."""
    def accept_all(spec, schedule, dev, obs, diagnostics=False, timer=None,
                   query_shard=None):
        ok = torch.ones(obs[0].shape[0], dtype=torch.bool)
        return {"verdict": ok, "plonk_ok": ok, "fri_ok": ok} if diagnostics else ok

    monkeypatch.setattr(verifier, "verify_device", accept_all)
    spec, batch = _tiny(4)
    batch[serde.VALID_MASK] = np.asarray([True, False, True, True])
    verdicts, n_accept = distributed.verify_batch_distributed(
        spec, batch, "cpu", valid_mask=np.asarray([True, True, False, True]))
    assert verdicts.tolist() == [True, False, False, True]
    assert n_accept == 2


def test_ranks_need_a_gpu_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.local_device()
    spec, batch = _tiny(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.verify_batch_distributed(spec, batch)
