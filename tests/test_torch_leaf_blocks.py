"""FRI's Merkle-leaf absorb blocks built from the batch's own leaves
(``fri/merkle.leaf_blocks``), on the CPU.

The device layout carries no absorb blocks (``*_leaf_packed``): FRI builds
them from the leaves it checks, on the card in one launch of
``csrc/fri_leaves.cu`` and here through the plain version.  Here:

- the plain blocks equal, bit for bit, ingest's own ``init_leaf_packed`` and
  ``step<j>_leaf_packed`` (widened) on step and decode_block, on the tiny
  spec (HashOrNoop oracles 2 and 3, one-block leaves) and on query windows
  (views of the widened batch); and, on random 64-bit words that ingest
  would refuse, what ingest's ``_pack_leaf_mont`` makes of them;
- the leaves' layout (``leaf_sources``), the wrapper's refusal of a CPU
  tensor and its host descriptor (the planes read in place, by their
  strides);
- the compiled verifier's layout holds no absorb block, and a load copies
  the smaller layout's bytes (50,886,656 at step B=256);
- soundness: a batch whose absorb blocks disagree with its leaves (zeroed,
  or another proof's) gets the verdicts, plonk_ok and fri_ok of the batch
  as ingested, and a leaf element changed in the JSON and ingested again
  fails fri_ok: the Merkle check hashes the leaves that FRI's evaluation
  check reads.

Limbs and verdicts are integers and booleans: every comparison is exact.
"""
import numpy as np
import pytest
import torch

from plonky2_tpu_torch import verifier
from plonky2_tpu_torch.fields import bn254
from plonky2_tpu_torch.fri import merkle
from plonky2_tpu_torch.fri.verify import query_rounds
from plonky2_tpu_torch.kernels import build
from plonky2_tpu_torch.kernels import fri_leaves as kl
from plonky2_tpu_torch.kernels import launches
from plonky2_tpu_torch.proof import serde
from plonky2_tpu_torch.proof.fixtures import (corrupt_leaf, decode_block_lanes,
                                              load_fixture)
from plonky2_tpu_torch.proof.synthetic import make_dummy_proof, make_tiny_spec

torch.set_num_threads(1)
PACKED = "_leaf_packed"


def _batch(name):
    """(spec, numpy batch): two proofs of a fixture (the second with a leaf
    element changed in its JSON), or three tiny-spec dummy proofs."""
    if name == "tiny":
        spec = make_tiny_spec(num_query_rounds=3)
        return spec, serde.stack_proofs([make_dummy_proof(spec, seed=s)
                                         for s in range(3)])
    spec, raw, vraw = load_fixture(f"testdata/{name}")
    return spec, serde.stack_proofs([serde.ingest_proof(spec, r, vraw)
                                     for r in (raw, corrupt_leaf(raw))])


def _window(tree, window):
    """Every tensor of a nest sliced along the query axis: views."""
    if isinstance(tree, tuple):
        return tuple(_window(t, window) for t in tree)
    return tree[:, window]


# (case, fixture, query shard): the last of 14 shards of decode_block's
# 28 rounds (2 rounds), the second of 4 of step's (7 rounds)
CASES = {"step": ("step", None), "decode_block": ("decode_block", None),
         "tiny": ("tiny", None), "step window": ("step", (1, 4)),
         "decode_block window": ("decode_block", (13, 14))}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name, shard = CASES[request.param]
    spec, batch = _batch(name)
    dev = verifier.proof_to_device(batch, "cpu")
    want = {k: torch.as_tensor(v.astype(np.int64)) for k, v in batch.items()
            if k.endswith(PACKED)}
    if shard is not None:
        window = slice(*query_rounds(spec, shard))
        qkeys = set(serde.query_axis_keys(spec))
        dev = {k: (_window(v, window) if k in qkeys else v)
               for k, v in dev.items()}
        want = {k: v[:, window] for k, v in want.items()}
        assert not dev["init_leaves_1"][0].is_contiguous()
    return spec, dev, want


def test_plain_blocks_equal_ingests(case):
    spec, dev, want = case
    assert not any(k.endswith(PACKED) for k in dev)
    launches.reset()
    got = merkle.leaf_blocks(spec, dev)
    assert not any(launches.read().values())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.int64 and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def test_random_words_pack_as_ingest_would():
    """Full-range 64-bit words, not all canonical (ingest refuses those):
    the blocks are still ingest's packing of the same integers."""
    spec = load_fixture("testdata/step")[0]
    rng = np.random.default_rng(19)
    batch = serde.zero_batch(spec, 1, 2)
    for k in batch:
        if k.startswith("init_leaves_") or k.endswith("_evals"):
            batch[k] = rng.integers(0, 1 << 64, size=batch[k].shape,
                                    dtype=np.uint64)
    batch["init_leaves_0"][0, 0, :3] = [0, (1 << 64) - 1, 1 << 63]
    got = merkle.leaf_blocks(spec, verifier.proof_to_device(batch, "cpu"))
    for src in merkle.leaf_sources(spec):
        for q in range(2):
            flat = [int(x) for x in batch[src.key][0, q].reshape(-1)]
            blocks = np.zeros((src.steps, 3, 16), np.int64)
            for t, (block, _) in enumerate(serde._pack_leaf_mont(flat)):
                blocks[t] = block
            mine = got[src.block_key][0, q]
            if src.oracle is not None:
                mine = mine[src.oracle]
            assert torch.equal(mine, torch.as_tensor(blocks)), (src.key, q)


def test_leaf_sources_of_the_step_circuit():
    spec = load_fixture("testdata/step")[0]
    got = [(s.key, s.n, s.comps, s.block_key, s.oracle, s.steps)
           for s in merkle.leaf_sources(spec)]
    assert got == [("init_leaves_0", 86, 1, "init_leaf_packed", 0, 16),
                   ("init_leaves_1", 136, 1, "init_leaf_packed", 1, 16),
                   ("init_leaves_2", 20, 1, "init_leaf_packed", 2, 16),
                   ("init_leaves_3", 16, 1, "init_leaf_packed", 3, 16),
                   ("step0_evals", 32, 2, "step0_leaf_packed", None, 4),
                   ("step1_evals", 32, 2, "step1_leaf_packed", None, 4)]
    assert merkle.R2_LIMBS == bn254.int_to_limbs(pow(2, 512, bn254.P))
    assert sum(w << (32 * i) for i, w in enumerate(kl.R2_WORDS)) == \
        bn254.limbs_to_int(merkle.R2_LIMBS)


def test_the_wrapper_takes_no_cpu_tensor():
    spec, batch = _batch("tiny")
    dev = verifier.proof_to_device(batch, "cpu")
    launches.reset()
    with pytest.raises(build.KernelError):
        kl.leaf_blocks(spec, dev)
    assert launches.read()["fri_leaf_blocks"] == 0


def test_descriptor_reads_the_planes_in_place():
    spec, batch = _batch("decode_block")
    dev = verifier.proof_to_device(batch, "cpu")
    qkeys = set(serde.query_axis_keys(spec))
    dev = {k: (_window(v, slice(26, 28)) if k in qkeys else v)
           for k, v in dev.items()}
    out = kl.outputs(spec, (2, 2), "cpu")
    assert {k: tuple(v.shape) for k, v in out.items()} == {
        "init_leaf_packed": (2, 2, 4, 16, 3, 16),
        "step0_leaf_packed": (2, 2, 4, 3, 16),
        "step1_leaf_packed": (2, 2, 4, 3, 16)}
    _, words = kl.descriptor(spec, dev, out)
    sources = merkle.leaf_sources(spec)
    assert len(words) == kl.HEAD + kl.SOURCE_WORDS * len(sources)
    assert words[:kl.HEAD] == [len(sources), 2, 2, *kl.R2_WORDS]
    for k, src in enumerate(sources):
        w = words[kl.HEAD + kl.SOURCE_WORDS * k:][:kl.SOURCE_WORDS]
        blocks = out[src.block_key]
        if src.oracle is not None:
            blocks = blocks[:, :, src.oracle]
        assert w[:5] == [blocks.data_ptr(), blocks.stride(1), src.steps,
                         src.n, src.comps]
        planes = [p for pair in merkle.leaf_planes(src, dev) for p in pair]
        assert len(planes) == 2 * src.comps
        for i, p in enumerate(planes):
            assert w[5 + 4 * i:9 + 4 * i] == [p.data_ptr(), *p.stride()]
        assert w[5 + 8 * src.comps:] == [0] * (16 - 8 * src.comps)
    bad = dict(dev, step1_evals=((dev["step1_evals"][0][0].to(torch.int32),
                                  dev["step1_evals"][0][1]),
                                 dev["step1_evals"][1]))
    with pytest.raises(ValueError, match="step1_evals"):
        kl.descriptor(spec, bad, out)
    with pytest.raises(ValueError, match="init_leaf_packed"):
        kl.descriptor(spec, dev, dict(out, init_leaf_packed=out[
            "init_leaf_packed"][:, :1]))


@pytest.mark.parametrize("name, B, nbytes", [("step", 256, 50_886_656),
                                             ("step", 64, 12_721_664),
                                             ("decode_block", 4, 748_032)])
def test_compiled_layout_carries_no_blocks(name, B, nbytes):
    spec = load_fixture(f"testdata/{name}")[0]
    entry = verifier.CompiledVerifier(spec, B, "cpu", "mxu")
    assert not any(s.name.endswith(PACKED) for s in entry.slots)
    assert "init_leaves_0" in {s.name for s in entry.slots}
    assert entry.bytes_in == nbytes


# decode_block [valid, bad opening, bad leaf, bad pow], three times over in
# one batch: as ingested, with every absorb block zeroed, and with each
# lane's blocks taken from the next lane's proof (the bad leaf's lane gets
# the blocks of untouched leaves)
DISAGREE = {"as_ingested": 0, "zeroed": 1, "other_proof": 2}


@pytest.fixture(scope="module")
def disagreeing():
    spec, raws, vraw = decode_block_lanes()
    batch, _, errors = serde.ingest_batch(spec, [(r, vraw) for r in raws])
    assert not errors
    lanes = np.arange(4)
    big = {k: np.concatenate([v, v, v]) for k, v in batch.items()}
    for k in big:
        if k.endswith(PACKED):
            big[k][4:8] = 0
            big[k][8:12] = batch[k][(lanes + 1) % 4]
    out = verifier.verify_batch(spec, big, device="cpu", diagnostics=True)
    return {k: v.tolist() for k, v in out.items()}


@pytest.mark.parametrize("blocks", ["zeroed", "other_proof"])
def test_disagreeing_blocks_change_no_verdict(disagreeing, blocks):
    group = DISAGREE[blocks]
    for k, v in disagreeing.items():
        assert v[4 * group:4 * group + 4] == v[:4], k


def test_a_leaf_changed_in_the_json_fails_fri(disagreeing):
    assert disagreeing["verdict"][:4] == [True, False, False, False]
    assert disagreeing["plonk_ok"][2] and not disagreeing["fri_ok"][2]
    assert disagreeing["plonk_ok"][10] and not disagreeing["fri_ok"][10]
