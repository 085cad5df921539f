"""What the compiled verifier rests on, checked on the CPU.

On the GPU, ``verifier.verify_on_device`` captures ``verify_device`` in a
CUDA graph once per key and replays it.  A capture fails on a copy from host
memory and on a host sync, and a replay must never take an input of another
shape.  Here:

- capture safety: after one warm-up, a second ``verify_device`` (the step
  fixture at B=1, and a query shard of the tiny spec) creates no tensor from
  host data (``torch.as_tensor``, ``torch.tensor`` and ``torch.from_numpy``
  patched to fail) and dispatches no host-sync or host-data op, under a
  ``TorchDispatchMode``, outside the kernels' entry points whose plain CPU
  versions stand in for the kernels (``poseidon_bn254.permute``,
  ``challenger.run_transcript`` and, since FRI's chain kernels,
  ``fri.merkle.merkle_roots``);
- the constant tables (``goldilocks.device_table``) are made once per
  content and device;
- the shape check (``verifier.check_inputs``) raises on another B, another
  query-round count, another dtype or another set of inputs, and never
  broadcasts; ``serde.batch_error`` checks a numpy batch against the shapes
  the circuit implies, which ``proof_shapes`` and ``zero_batch`` state and
  the fixtures and the tiny spec's dummy proofs have.
"""
import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from plonky2_tpu_torch import verifier
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.fri import merkle
from plonky2_tpu_torch.hash import poseidon_bn254 as pb
from plonky2_tpu_torch.proof import serde
from plonky2_tpu_torch.proof.fixtures import load_fixture
from plonky2_tpu_torch.proof.synthetic import make_dummy_proof, make_tiny_spec
from plonky2_tpu_torch.transcript import challenger as chal

# host syncs, and tensors made from host data
BLOCKED = {getattr(torch.ops.aten, name) for name in (
    "_local_scalar_dense", "is_nonzero", "item", "nonzero", "masked_select",
    "lift_fresh", "equal")}


class HostTraffic(TorchDispatchMode):
    """Counts the BLOCKED ops dispatched outside an opaque region."""

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()
        self.opaque = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.opaque and func.overloadpacket in BLOCKED:
            self.seen[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """A verification is thousands of tiny ops: one thread runs them
    fastest, and the test workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _probe(monkeypatch, run):
    """BLOCKED ops and host-data tensors of ``run()`` outside the kernels'
    entry points."""
    mode = HostTraffic()
    made = collections.Counter()

    def opaque(fn):
        def call(*args, **kwargs):
            mode.opaque += 1
            try:
                return fn(*args, **kwargs)
            finally:
                mode.opaque -= 1
        return call

    def counted(name, fn):
        def call(*args, **kwargs):
            if not mode.opaque:
                made[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(pb, "permute", opaque(pb.permute))
    monkeypatch.setattr(merkle, "merkle_roots", opaque(merkle.merkle_roots))
    monkeypatch.setattr(chal, "run_transcript", opaque(chal.run_transcript))
    for name in ("as_tensor", "tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, counted(name, getattr(torch, name)))
    with mode:
        out = run()
    monkeypatch.undo()
    return out, dict(mode.seen), dict(made)


@pytest.fixture(scope="module")
def step_b1():
    spec, raw, vraw = load_fixture("testdata/step")
    batch = serde.stack_proofs([serde.ingest_proof(spec, raw, vraw)])
    return spec, batch


def test_second_verification_is_capture_safe(step_b1, monkeypatch):
    spec, batch = step_b1
    schedule, dev, obs = verifier.prepare(spec, batch, "cpu")

    def run():
        return verifier.verify_device(spec, schedule, dev, obs,
                                      diagnostics=True)

    warm = run()
    out, seen, made = _probe(monkeypatch, run)
    assert seen == {} and made == {}
    assert out["verdict"].tolist() == warm["verdict"].tolist() == [True]


def test_query_shard_verification_is_capture_safe(monkeypatch):
    spec = make_tiny_spec(num_query_rounds=2)
    batch = serde.stack_proofs([make_dummy_proof(spec, seed=s)
                                for s in range(2)])
    qkeys = serde.query_axis_keys(spec)
    part = {k: (v[:, 1:] if k in qkeys else v) for k, v in batch.items()}
    schedule, dev, obs = verifier.prepare(spec, part, "cpu")

    def run():
        return verifier.verify_device(spec, schedule, dev, obs,
                                      diagnostics=True, query_shard=(1, 2))

    warm = run()
    out, seen, made = _probe(monkeypatch, run)
    assert seen == {} and made == {}
    for k in warm:
        assert out[k].tolist() == warm[k].tolist()


def test_device_table_is_made_once_per_content_and_device():
    a = gl.device_table(np.arange(6).reshape(2, 3), "cpu")
    b = gl.device_table([[0, 1, 2], [3, 4, 5]], torch.device("cpu"))
    assert a is b and a.dtype == torch.int64 and a.shape == (2, 3)
    m = gl.device_table(np.asarray([True, False]), "cpu")
    assert m.dtype == torch.bool and m.tolist() == [True, False]
    assert gl.device_table([1, 0], "cpu") is not m
    assert gl.device_table([1, 0], "cpu", np.uint8).dtype == torch.uint8


def _tensors(spec, batch):
    _, dev, obs = verifier.prepare(spec, batch, "cpu")
    return {"proof": dev, "obs": obs}


@pytest.fixture(scope="module")
def tiny():
    spec = make_tiny_spec(num_query_rounds=2)
    batch = serde.stack_proofs([make_dummy_proof(spec, seed=s)
                                for s in range(2)])
    static = _tensors(spec, serde.zero_batch(spec, 2))
    return spec, batch, static


def test_check_inputs_takes_the_layout_of_its_key(tiny):
    spec, batch, static = tiny
    verifier.check_inputs(static, _tensors(spec, batch))


@pytest.mark.parametrize("change", ["batch", "query_rounds", "dtype",
                                    "missing"])
def test_check_inputs_raises_and_never_broadcasts(tiny, change):
    spec, batch, static = tiny
    qkeys = serde.query_axis_keys(spec)
    if change == "batch":
        given = _tensors(spec, {k: v[:1] for k, v in batch.items()})
    elif change == "query_rounds":
        # one round of two: copy_ would broadcast it over the static buffer
        given = _tensors(spec, {k: (v[:, :1] if k in qkeys else v)
                                for k, v in batch.items()})
        torch.broadcast_shapes(given["proof"]["init_siblings"].shape,
                               static["proof"]["init_siblings"].shape)
    elif change == "dtype":
        given = _tensors(spec, batch)
        given["proof"]["init_siblings"] = \
            given["proof"]["init_siblings"].to(torch.int32)
    else:
        given = _tensors(spec, batch)
        del given["proof"]["final_poly"]
    with pytest.raises(ValueError, match="compiled verifier"):
        verifier.check_inputs(static, given)


@pytest.mark.parametrize("circuit", ["testdata/step", "testdata/decode_block"])
def test_proof_shapes_are_what_ingest_makes(circuit):
    spec, raw, vraw = load_fixture(circuit)
    proof = serde.ingest_proof(spec, raw, vraw)
    want = serde.proof_shapes(spec)
    assert {k: (np.shape(v), np.asarray(v).dtype)
            for k, v in proof.items()} == want
    batch, _, _ = serde.ingest_batch(spec, [(raw, vraw)] * 2)
    assert serde.batch_error(spec, batch) is None
    zeros = serde.zero_batch(spec, 3)
    assert serde.batch_error(spec, zeros) is None
    assert all(not v.any() for v in zeros.values())


def test_batch_error_names_what_differs(tiny):
    spec, batch, _ = tiny
    assert serde.batch_error(spec, batch) is None
    qkeys = serde.query_axis_keys(spec)
    one_round = {k: (v[:, :1] if k in qkeys else v) for k, v in batch.items()}
    assert serde.batch_error(spec, one_round).startswith("init_leaves_0")
    assert serde.batch_error(spec, one_round, num_query_rounds=1) is None
    wrong_dtype = dict(batch, pow_witness=batch["pow_witness"].astype(np.int64))
    assert "pow_witness" in serde.batch_error(spec, wrong_dtype)
    missing = {k: v for k, v in batch.items() if k != "final_poly"}
    assert "final_poly" in serde.batch_error(spec, missing)
    bad_mask = dict(batch, **{serde.VALID_MASK: np.ones(3, bool)})
    assert serde.VALID_MASK in serde.batch_error(spec, bad_mask)
    one_proof = {k: v[0] for k, v in batch.items()}
    assert "not (B,)" in serde.batch_error(spec, one_proof)
