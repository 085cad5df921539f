"""The compiled verifier (one CUDA graph per key) on the card.  Every test
here carries the ``cuda`` marker and skips where ``torch.cuda.is_available()``
is false.  On a machine with a GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_compiled_cuda.py

- the replay of decode_block [valid, bad opening, bad leaf, bad pow] gives
  the eager ``verify_device``'s verdict, plonk_ok and fri_ok, bit for bit;
- the same graph re-fed with the lanes in another order gives that order's
  verdicts: nothing of the first batch is baked in at capture;
- a batch with another query-round count raises ValueError, and the graph
  still gives the right verdicts after;
- two batches of one key loaded and replayed back to back, neither read
  before both are issued, the first's copy to the card held back on the
  stream, each give their own verdicts: the pinned staging buffer is not
  packed again while a copy from it is in flight;
- the cache holds at most 8 entries and frees an evicted entry's graph and
  memory pool;
- with a ``StageTimer`` the compiled path gives the same outputs and times
  its host stages apart;
- the stage probe's plonk and fri phases, each captured in its own graph
  (``verifier.capture``) and re-fed the lanes in another order, give the
  compiled verifier's plonk_ok and fri_ok;
- a capture that cannot be captured (a host sync inside) raises, and the
  next capture works;
- at step B=256, with FRI's absorb blocks built on the card, the compiled
  verifier gives the outputs of the eager path fed ingest's blocks, under
  both Poseidon-BN254 forms, and its layout carries no block.
"""
import gc
import weakref

import pytest
import torch

from plonky2_tpu_torch import verifier
from plonky2_tpu_torch.hash import poseidon_bn254 as pb
from plonky2_tpu_torch.proof import serde
from plonky2_tpu_torch.proof.fixtures import decode_block_lanes
from plonky2_tpu_torch.proof.synthetic import make_dummy_proof, make_tiny_spec
from plonky2_tpu_torch.tools import profile_verify
from plonky2_tpu_torch.utils.profiling import StageTimer

pytestmark = pytest.mark.cuda
EXPECTED = [True, False, False, False]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def decode_block():
    spec, raws, vraw = decode_block_lanes("testdata/decode_block")
    batch, _, errors = serde.ingest_batch(spec, [(r, vraw) for r in raws])
    assert not errors
    return spec, batch


def _host(out):
    return {k: v.cpu().tolist() for k, v in out.items()}


@pytest.mark.parametrize("impl", pb.IMPLS)
def test_replay_equals_eager_on_decode_block(dev, decode_block, impl):
    spec, batch = decode_block
    with pb.use_impl(impl):
        replay = _host(verifier.verify_on_device(spec, batch, dev))
        schedule, d, obs = verifier.prepare(spec, batch, dev)
        eager = _host(verifier.verify_device(spec, schedule, d, obs,
                                             diagnostics=True))
        entry = verifier.compiled_verifier(spec, 4, dev, impl)
    assert entry.graph is not None
    assert replay == eager and replay["verdict"] == EXPECTED


def test_refed_batch_gives_its_own_verdicts(dev, decode_block):
    spec, batch = decode_block
    first = _host(verifier.verify_on_device(spec, batch, dev))
    hits = verifier.compiled_verifier.cache_info().hits
    order = [3, 0, 2, 1]
    again = _host(verifier.verify_on_device(
        spec, {k: v[order] for k, v in batch.items()}, dev))
    assert verifier.compiled_verifier.cache_info().hits == hits + 1
    for k in first:
        assert again[k] == [first[k][i] for i in order]


def test_malformed_batch_raises_and_the_graph_still_works(dev, decode_block):
    spec, batch = decode_block
    verifier.verify_on_device(spec, batch, dev)
    qkeys = serde.query_axis_keys(spec)
    one_round = {k: (v[:, :1] if k in qkeys else v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="query rounds"):
        verifier.verify_on_device(spec, one_round, dev)
    again = _host(verifier.verify_on_device(spec, batch, dev))
    assert again["verdict"] == EXPECTED


def test_back_to_back_loads_of_one_key_keep_their_batches(dev,
                                                         decode_block):
    spec, batch = decode_block
    verifier.verify_on_device(spec, batch, dev)  # the key's graph
    entry = verifier.compiled_verifier(spec, 4, dev, pb.kernel_impl())
    bad_first = {k: v[[1, 1, 2, 3]] for k, v in batch.items()}
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 26)  # the first copy waits behind this
        first = verifier.verify_on_device(spec, batch, dev)
        second = verifier.verify_on_device(spec, bad_first, dev)
    assert entry.staging.is_pinned()
    assert _host(first)["verdict"] == EXPECTED
    assert _host(second)["verdict"] == [False] * 4


def test_compiled_cache_evicts_and_frees_at_maxsize(dev):
    spec = make_tiny_spec()
    maxsize = verifier.compiled_verifier.cache_info().maxsize
    verifier.compiled_verifier.cache_clear()
    entries = []
    for b in range(1, maxsize + 2):
        batch = serde.stack_proofs([make_dummy_proof(spec, seed=s)
                                    for s in range(b)])
        out = verifier.verify_on_device(spec, batch, dev)
        assert out["verdict"].cpu().tolist() == [False] * b
        entries.append(weakref.ref(verifier.compiled_verifier(
            spec, b, dev, pb.kernel_impl())))
    assert verifier.compiled_verifier.cache_info().currsize == maxsize
    gc.collect()
    assert entries[0]() is None  # the least recently used key went first
    assert all(e() is not None for e in entries[1:])
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved(dev)
    verifier.compiled_verifier.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    assert all(e() is None for e in entries)
    assert torch.cuda.memory_reserved(dev) < held


def test_timer_stages_on_the_compiled_path(dev, decode_block):
    spec, batch = decode_block
    plain = _host(verifier.verify_on_device(spec, batch, dev))
    timer = StageTimer(dev)
    timed = _host(verifier.verify_on_device(spec, batch, dev, timer=timer))
    assert timed == plain and plain["verdict"] == EXPECTED
    assert list(timer.timings) == ["observed", "convert", "copy_in",
                                   "replay", "outputs"]


@pytest.mark.parametrize("name,key", [("plonk", "plonk_ok"),
                                      ("fri", "fri_ok")])
def test_phase_graphs_refed_give_the_compiled_verifiers(dev, decode_block,
                                                        name, key):
    spec, batch = decode_block
    schedule, d, obs = verifier.prepare(spec, batch, dev)
    phase = profile_verify.PHASES[name]
    with torch.cuda.device(dev):
        graph, out, _, _ = verifier.capture(
            lambda: phase(spec, schedule, d, obs), dev)
        for order in ([0, 1, 2, 3], [3, 0, 2, 1]):
            lanes = {k: v[order] for k, v in batch.items()}
            _, d2, obs2 = verifier.prepare(spec, lanes, dev)
            for (_, static), (_, x) in zip(verifier._leaves((d, obs)),
                                           verifier._leaves((d2, obs2))):
                static.copy_(x)
            graph.replay()
            want = verifier.verify_on_device(spec, lanes, dev)[key]
            assert out.cpu().tolist() == want.cpu().tolist()


def test_failed_capture_raises_and_the_next_capture_works(dev):
    x = torch.arange(8, device=dev)
    with torch.cuda.device(dev):
        with pytest.raises(RuntimeError):
            verifier.capture(lambda: x * int(x.sum().item()), dev)
        graph, out, _, _ = verifier.capture(lambda: x * 2, dev)
        x.add_(1)
        graph.replay()
    assert out.cpu().tolist() == [2 * (i + 1) for i in range(8)]


# FRI's absorb blocks built on the card: at step B=256, lanes of the
# decode_block-style corruptions of the step proof tiled over the batch, the
# compiled verifier's three outputs equal those of the eager verify_device
# fed ingest's own blocks (the path where they came from the host), under
# both Poseidon-BN254 forms; its layout carries no block, its load copies
# 50,886,656 bytes, and a key's first call launches the builder twice (the
# warm-up and the capture) and a replay launches it inside the graph.
@pytest.fixture(scope="module")
def step_256():
    from plonky2_tpu_torch.proof.fixtures import (corrupt_leaf,
                                                  corrupt_pow_witness,
                                                  corrupt_wires_opening,
                                                  load_fixture)
    spec, raw, vraw = load_fixture("testdata/step")
    proofs = [serde.ingest_proof(spec, r, vraw) for r in
              (raw, corrupt_wires_opening(raw), corrupt_leaf(raw, -1),
               corrupt_pow_witness(raw))]
    lanes = [0] * 256
    lanes[1], lanes[130], lanes[255] = 1, 2, 3
    return spec, serde.stack_proofs([proofs[i] for i in lanes])


@pytest.mark.parametrize("impl", pb.IMPLS)
def test_blocks_built_on_the_card_change_no_output(dev, step_256, impl,
                                                   monkeypatch):
    from plonky2_tpu_torch.fri import merkle
    from plonky2_tpu_torch.kernels import fri_leaves as kl

    spec, batch = step_256
    with pb.use_impl(impl):
        verifier.compiled_verifier.cache_clear()
        before = kl.leaf_blocks.launches
        got = verifier.verify_batch(spec, batch, device=dev, diagnostics=True)
        assert kl.leaf_blocks.launches == before + 2
        again = verifier.verify_batch(spec, batch, device=dev,
                                      diagnostics=True)
        assert kl.leaf_blocks.launches == before + 2
        entry = verifier.compiled_verifier(spec, 256, dev, impl)
        shipped = {k: torch.as_tensor(v.astype("int64")).to(dev)
                   for k, v in batch.items() if k.endswith("_leaf_packed")}
        monkeypatch.setattr(merkle, "leaf_blocks", lambda spec, d: shipped)
        schedule, d, obs = verifier.prepare(spec, batch, dev)
        eager = _host(verifier.verify_device(spec, schedule, d, obs,
                                             diagnostics=True))
    assert not any(s.name.endswith("_leaf_packed") for s in entry.slots)
    assert entry.bytes_in == 50_886_656
    want = [True] * 256
    want[1] = want[130] = want[255] = False
    assert eager["verdict"] == want
    assert {k: v.tolist() for k, v in got.items()} == eager
    assert {k: v.tolist() for k, v in again.items()} == eager
