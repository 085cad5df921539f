"""End-to-end verification with the port on the CPU (plain torch path of
both kernels).

decode_block batch [valid, bad opening, bad leaf, bad pow]: every
corruption is made on the raw JSON, so the port and the JAX package's
independent Python-int verifier (``bench.cpu_reference.verify``) read the
same input.  The per-lane verdicts must agree with it and equal
[True, False, False, False], the verdict the JAX ``verify_batch`` is pinned
to in test_verify_e2e.py.  The JAX package's own ``serde.stack_proofs``
batch, converted by ``proof.convert.from_reference``, must give the same
verdicts.  Verdicts are booleans, compared exactly."""
import copy

import numpy as np
import pytest
import torch

from plonky2_tpu.bench import cpu_reference as R
from plonky2_tpu.proof import serde as jserde
from plonky2_tpu.proof.spec import load_circuit_spec as jload_spec
from plonky2_tpu_torch import verifier
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.fri.verify import verify_fri
from plonky2_tpu_torch.proof import convert, serde
from plonky2_tpu_torch.proof.fixtures import decode_block_lanes, load_fixture

torch.set_num_threads(1)
EXPECTED = [True, False, False, False]


@pytest.fixture(scope="module")
def decode_block():
    spec, raws, vraw = decode_block_lanes()
    batch, mask, errors = serde.ingest_batch(spec, [(r, vraw) for r in raws])
    assert not errors
    out = verifier.verify_batch(spec, batch, valid_mask=mask, device="cpu",
                                diagnostics=True)
    return dict(spec=spec, raws=raws, vraw=vraw, batch=batch, out=out)


def test_decode_block_verdicts_match_cpu_reference(decode_block):
    jspec = jload_spec("testdata/decode_block/common_circuit_data.json")
    ref = [bool(R.verify(jspec, r, decode_block["vraw"]))
           for r in decode_block["raws"]]
    assert ref == EXPECTED
    assert decode_block["out"]["verdict"].tolist() == ref


def test_decode_block_plonk_and_fri_diagnostics(decode_block):
    plonk_ok = decode_block["out"]["plonk_ok"].tolist()
    fri_ok = decode_block["out"]["fri_ok"].tolist()
    assert plonk_ok[0] and fri_ok[0]                  # valid
    assert not plonk_ok[1]                            # bad opening
    assert plonk_ok[2] and not fri_ok[2]              # bad leaf
    assert plonk_ok[3] and not fri_ok[3]              # bad pow


def test_reference_batch_through_from_reference(decode_block):
    """The JAX package's own ingest + stack_proofs batch, fed to the port."""
    jspec = jload_spec("testdata/decode_block/common_circuit_data.json")
    jbatch = jserde.stack_proofs([jserde.ingest_proof(jspec, r, decode_block["vraw"])
                                  for r in decode_block["raws"]])
    converted = convert.from_reference(jbatch)
    own = verifier.proof_to_device(decode_block["batch"], "cpu")
    assert sorted(converted) == sorted(own)
    for k, v in own.items():
        flat_a = [t for t in _leaves(v)]
        flat_b = [t for t in _leaves(converted[k])]
        assert all(torch.equal(a, b) for a, b in zip(flat_a, flat_b)), k
    got = verifier.verify_batch(decode_block["spec"], jbatch, device="cpu")
    assert got.tolist() == EXPECTED


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for item in x for t in _leaves(item)]


def test_step_fixture_accepted():
    spec, raw, vraw = load_fixture("testdata/step")
    jspec = jload_spec("testdata/step/common_circuit_data.json")
    assert R.verify(jspec, raw, vraw)
    assert verifier.verify_one(spec, serde.ingest_proof(spec, raw, vraw),
                               device="cpu")


def test_convert_helpers_round_trip():
    rng = np.random.default_rng(4)
    vals = rng.integers(0, gl.P, size=(3, 5), dtype=np.uint64)
    pair = ((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (vals >> np.uint64(32)).astype(np.uint32))
    t = convert.gl_from_pair(pair)
    assert np.array_equal(gl.join_u64(t), vals)
    back = convert.gl_to_pair(t)
    assert np.array_equal(back[0], pair[0]) and np.array_equal(back[1], pair[1])
    limbs = rng.integers(0, 1 << 16, size=(2, 4, 16)).astype(np.uint32)
    assert np.array_equal(convert.bn_to_limbs(convert.bn_from_limbs(limbs)), limbs)


def test_quarantined_lane_is_false_without_valid_mask(decode_block):
    """Hazard 1 repaired: the batch of ``ingest_batch`` carries its mask and
    ``verify_batch`` applies it, so the lane filled with a copy of the valid
    proof is False though the caller drops the mask.  This deliberately
    differs from the JAX package, whose batch has no mask entry: there lane 1
    is the filler proof, bit for bit, and verifies as True unless the caller
    passes the mask."""
    spec, raw, vraw = (decode_block["spec"], decode_block["raws"][0],
                       decode_block["vraw"])
    truncated = copy.deepcopy(raw)
    truncated["proof"]["openings"]["wires"] = \
        truncated["proof"]["openings"]["wires"][:-1]
    pairs = [(raw, vraw), (truncated, vraw)]
    batch, mask, errors = serde.ingest_batch(spec, pairs)
    assert mask.tolist() == [True, False] and list(errors) == [1]
    assert batch[serde.VALID_MASK].tolist() == [True, False]
    assert verifier.verify_batch(spec, batch, device="cpu").tolist() == \
        [True, False]

    jspec = jload_spec("testdata/decode_block/common_circuit_data.json")
    jbatch, jmask, _ = jserde.ingest_batch(jspec, pairs)
    assert serde.VALID_MASK not in jbatch and jmask.tolist() == [True, False]
    assert all(np.array_equal(v[1], v[0]) for v in jbatch.values())


def test_wrong_query_round_count_raises(decode_block):
    """Hazard 2 repaired: Q comes from the spec; a batch with one query
    round fewer is malformed and raises before any check runs."""
    spec, batch = decode_block["spec"], decode_block["batch"]
    Q = spec.num_query_rounds
    per_query = [k for k in batch if k.startswith(("init_", "step"))]
    cut = {k: (v[:, :Q - 1] if k in per_query else v) for k, v in batch.items()}
    dev = verifier.proof_to_device(cut, "cpu")
    with pytest.raises(ValueError, match="query rounds"):
        verify_fri(spec, dev, challenges=None, verdict=None)


def test_verify_batch_needs_a_gpu_unless_asked_for_the_cpu(decode_block):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device=.cpu."):
        verifier.verify_batch(decode_block["spec"], decode_block["batch"])
    with pytest.raises(RuntimeError):
        verifier.verify_one(decode_block["spec"],
                            serde.ingest_proof(decode_block["spec"],
                                               decode_block["raws"][0],
                                               decode_block["vraw"]))
