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
- the cache holds at most 8 entries and frees an evicted entry's graph and
  memory pool.
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
