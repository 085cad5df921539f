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
import numpy as np
import pytest
import torch

from plonky2_tpu.bench import cpu_reference as R
from plonky2_tpu.proof import serde as jserde
from plonky2_tpu.proof.spec import load_circuit_spec as jload_spec
from plonky2_tpu_torch import verifier
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.proof import convert, serde
from plonky2_tpu_torch.proof.fixtures import decode_block_lanes, load_fixture

torch.set_num_threads(1)
EXPECTED = [True, False, False, False]


@pytest.fixture(scope="module")
def decode_block():
    spec, raws, vraw = decode_block_lanes()
    batch, mask, errors = serde.ingest_batch(spec, [(r, vraw) for r in raws])
    assert not errors
    out = verifier.verify_batch(spec, batch, valid_mask=mask, diagnostics=True)
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
    got = verifier.verify_batch(decode_block["spec"], jbatch)
    assert got.tolist() == EXPECTED


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for item in x for t in _leaves(item)]


def test_step_fixture_accepted():
    spec, raw, vraw = load_fixture("testdata/step")
    jspec = jload_spec("testdata/step/common_circuit_data.json")
    assert R.verify(jspec, raw, vraw)
    assert verifier.verify_one(spec, serde.ingest_proof(spec, raw, vraw))


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
