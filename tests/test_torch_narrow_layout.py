"""The narrow proof layout (``proof/convert.py``) against the JAX package's,
and the compiled verifier's loading of it, on the CPU.

- ``to_narrow`` gives, key by key, the leaves of the JAX
  ``verifier.proof_to_device_np``, word for word (compared as uint32), on
  step and decode_block at B=2 and on a ``serde.zero_batch``, but for the
  Merkle leaves' absorb blocks (``*_leaf_packed``), which it leaves out:
  FRI builds them from the leaves (``fri/merkle.leaf_blocks``,
  ``tests/test_torch_leaf_blocks.py``); ``split_words`` gives
  ``_split_u64_np``'s words;
- ``widen(to_narrow(b))`` equals the parent form of ``from_reference`` (the
  plain reference below: each uint64 split into int64 halves through
  ``goldilocks.split_u64``, each uint32 limb cast to int64), the absorb
  blocks left out, bit for bit, with its keys, their order, shapes and
  dtypes, on the fixtures and on random words with 0, p - 1, 2^63 and
  2^64 - 1 among them;
- one flat int32 buffer (``flat_layout``, ``pack``, ``narrow_views``) holds
  that layout: its views equal ``to_narrow`` of the packed batch;
- ``CompiledVerifier.load`` (an entry on the CPU: no graph is made here)
  packs a batch, query-window slices of a 2-D mesh too, and refuses a batch
  of one query round where the key has 28, a transposed array, another
  batch size, another dtype and a missing key with ``ValueError`` before
  anything is copied.
"""
import numpy as np
import pytest
import torch

from plonky2_tpu.verifier import _split_u64_np, proof_to_device_np
from plonky2_tpu_torch import verifier
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.proof import convert, serde
from plonky2_tpu_torch.proof.fixtures import (corrupt_wires_opening,
                                              decode_block_lanes,
                                              load_fixture)
from plonky2_tpu_torch.transcript import challenger as chal


PACKED = "_leaf_packed"  # the absorb blocks' keys end so


def _parent_from_reference(batch_np):
    """``from_reference`` as it was before the narrow layout, without the
    absorb blocks."""
    dev = {}
    for k, v in batch_np.items():
        if k == serde.VALID_MASK or k.endswith(PACKED):
            continue
        v = np.asarray(v)
        if v.dtype == np.uint64:
            if k.endswith("_tovec"):
                continue
            if convert._is_qe(k):
                dev[k] = (gl.split_u64(v[..., 0]), gl.split_u64(v[..., 1]))
            else:
                dev[k] = gl.split_u64(v)
        else:
            dev[k] = torch.as_tensor(v.astype(np.int64))
    return dev


@pytest.fixture(scope="module")
def batches():
    spec_s, raw, vraw = load_fixture("testdata/step")
    step = serde.stack_proofs([
        serde.ingest_proof(spec_s, raw, vraw),
        serde.ingest_proof(spec_s, corrupt_wires_opening(raw), vraw)])
    spec_d, raws, vraw_d = decode_block_lanes()
    db = serde.stack_proofs([serde.ingest_proof(spec_d, r, vraw_d)
                             for r in raws[:2]])
    return {"step": (spec_s, step), "decode_block": (spec_d, db),
            "zero_batch": (spec_s, serde.zero_batch(spec_s, 2))}


def _random_batch(seed=7):
    """Random words in the layout's kinds: GL, QE (trailing axis 2), uint32
    limbs, with edge values, a ``*_tovec`` chunk and a mask to drop."""
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, gl.P - 1, gl.P, 1 << 31, (1 << 32) - 1, 1 << 32,
                      1 << 63, (1 << 64) - 1], dtype=np.uint64)
    words = rng.integers(0, 1 << 64, size=64, dtype=np.uint64)
    words[:edges.size] = edges
    limbs = rng.integers(0, 1 << 32, size=48, dtype=np.uint32)
    limbs[:4] = [0, (1 << 16) - 1, 1 << 31, (1 << 32) - 1]
    return {"public_inputs": words[:12].reshape(2, 6),
            "op_wires": words[12:36].reshape(2, 6, 2),
            "step0_evals": words[36:52].reshape(2, 2, 2, 2),
            "pow_witness": words[52:54],
            "init_siblings": limbs.reshape(2, 3, 8),
            "wires_cap_tovec": words[54:64].reshape(2, 5),
            serde.VALID_MASK: np.array([True, False])}


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in _flat(item)]
    return [tree]


@pytest.mark.parametrize("name", ["step", "decode_block", "zero_batch"])
def test_to_narrow_equals_jax_proof_to_device_np(batches, name):
    spec, batch = batches[name]
    ours, jax = convert.to_narrow(batch), proof_to_device_np(batch)
    packed = [k for k in jax if k.endswith(PACKED)]
    assert packed == ["init_leaf_packed", "step0_leaf_packed",
                      "step1_leaf_packed"]
    assert list(ours) == [k for k in jax if k not in packed]
    assert not any(k.endswith("_tovec") for k in ours)
    for k in ours:
        mine, theirs = _flat(ours[k]), _flat(jax[k])
        assert len(mine) == len(theirs), k
        for a, b in zip(mine, theirs):
            assert a.dtype == np.int32 and b.dtype == np.uint32, k
            assert a.shape == b.shape and np.array_equal(a.view(np.uint32), b)
    observed = chal.build_observed_host(spec, batch)
    for a, b in zip(convert.split_words(observed), _split_u64_np(observed)):
        assert np.array_equal(a.view(np.uint32), b)


def _assert_same_tensors(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = _flat(got[k]), _flat(want[k])
        assert len(g) == len(w), k
        for a, b in zip(g, w):
            assert a.dtype == b.dtype == torch.int64, k
            assert a.shape == b.shape and a.is_contiguous(), k
            assert torch.equal(a, b), k


@pytest.mark.parametrize("name", ["step", "decode_block", "zero_batch",
                                  "random"])
def test_widen_of_to_narrow_equals_the_parent_from_reference(batches, name):
    batch = _random_batch() if name == "random" else batches[name][1]
    want = _parent_from_reference(batch)
    _assert_same_tensors(convert.widen(convert.to_narrow(batch)), want)
    _assert_same_tensors(convert.from_reference(batch), want)
    if name == "random":
        assert (want["public_inputs"][0] >= 0).all()  # masked, not signed
        assert want["init_siblings"].max() == (1 << 32) - 1


def test_narrow_layout_takes_only_uint64_and_uint32():
    with pytest.raises(TypeError, match="int64"):
        convert.to_narrow({"init_siblings": np.zeros((2, 3), np.int64)})
    with pytest.raises(TypeError, match="int32"):
        convert.widen({"x": torch.zeros(2, dtype=torch.int64)})


def _arrays(spec, batch):
    arrays = convert.device_arrays(batch)
    arrays[verifier.OBSERVED] = chal.build_observed_host(spec, batch)
    return arrays


@pytest.mark.parametrize("name", ["step", "random"])
def test_flat_buffer_holds_the_narrow_layout(batches, name):
    if name == "random":
        batch = _random_batch()
        arrays = convert.device_arrays(batch)
    else:
        spec, batch = batches[name]
        arrays = _arrays(spec, batch)
    slots, words = convert.flat_layout(arrays)
    ends = [0] + [s.offset + s.words for s in slots]
    assert all(s.offset % convert.ALIGN == 0 and s.offset >= end
               for s, end in zip(slots, ends))
    assert words >= ends[-1] and words - ends[-1] < convert.ALIGN
    host = np.full(words, -1, np.int32)
    convert.pack(slots, host, arrays)
    views = convert.narrow_views(slots, host)
    want = {k: convert._narrow(k, v) for k, v in arrays.items()}
    assert list(views) == list(want)
    for k in want:
        for a, b in zip(_flat(views[k]), _flat(want[k])):
            assert a.dtype == np.int32 and np.array_equal(a, b), k
    flat_t = torch.from_numpy(host)
    _assert_same_tensors(
        convert.widen(convert.narrow_views(slots, flat_t)),
        _parent_from_reference(arrays))


@pytest.fixture(scope="module")
def step_entry(batches):
    spec, batch = batches["step"]
    return verifier.CompiledVerifier(spec, 2, "cpu", "mxu")


def test_entry_inputs_are_int32_views_of_its_flat_buffer(step_entry):
    flat = step_entry.flat
    assert flat.dtype == torch.int32
    assert step_entry.bytes_in == 4 * flat.numel()
    lo, hi = flat.data_ptr(), flat.data_ptr() + step_entry.bytes_in
    for name, t in verifier._leaves(step_entry.inputs):
        assert t.dtype == torch.int32, name
        assert lo <= t.data_ptr() < hi, name


def test_load_packs_the_batch(batches, step_entry):
    spec, batch = batches["step"]
    step_entry.load(batch)
    want = convert.to_narrow(batch)
    got = step_entry.inputs["proof"]
    for k in want:
        for a, b in zip(_flat(got[k]), _flat(want[k])):
            assert np.array_equal(a.numpy(), b), k
    observed = convert.split_words(chal.build_observed_host(spec, batch))
    for a, b in zip(step_entry.inputs["obs"], observed):
        assert np.array_equal(a.numpy(), b)
    assert torch.equal(step_entry.flat, step_entry.staging)


@pytest.mark.parametrize("view", ["query_window", "reversed_lanes"])
def test_load_takes_strided_views(batches, view):
    """The 2-D mesh's query shards (non-contiguous slices of the batch) and
    lanes in reverse (negative strides) load as their contiguous copies."""
    spec, batch = batches["step"]
    if view == "query_window":
        entry = verifier.CompiledVerifier(spec, 2, "cpu", "mxu", (1, 2))
        qkeys = set(serde.query_axis_keys(spec))
        Q = spec.num_query_rounds
        part = {k: (v[:, Q // 2:] if k in qkeys else v)
                for k, v in batch.items()}
    else:
        entry = verifier.CompiledVerifier(spec, 2, "cpu", "mxu")
        part = {k: v[::-1] for k, v in batch.items()}
    assert not part["init_siblings"].flags.c_contiguous
    entry.load(part)
    want = convert.to_narrow({k: np.ascontiguousarray(v)
                              for k, v in part.items()})
    for k in want:
        for a, b in zip(_flat(entry.inputs["proof"][k]), _flat(want[k])):
            assert np.array_equal(a.numpy(), b), k


def _malformed(spec, batch, change):
    qkeys = serde.query_axis_keys(spec)
    if change == "one_query_round":
        return {k: (v[:, :1] if k in qkeys else v) for k, v in batch.items()}
    if change == "transposed":
        return dict(batch, op_wires=np.swapaxes(batch["op_wires"], 1, 2))
    if change == "batch_size":
        return {k: v[:1] for k, v in batch.items()}
    if change == "dtype":
        return dict(batch, init_siblings=batch["init_siblings"].astype(
            np.uint64))
    return {k: v for k, v in batch.items() if k != "final_poly"}


@pytest.mark.parametrize("change", ["one_query_round", "transposed",
                                    "batch_size", "dtype", "missing"])
def test_load_refuses_a_malformed_batch_before_any_copy(batches, change):
    spec, batch = batches["step"]
    bad = _malformed(spec, batch, change)
    fresh = verifier.CompiledVerifier(spec, 2, "cpu", "mxu")
    match = "query rounds" if change == "one_query_round" else "layout"
    with pytest.raises(ValueError, match=match):
        fresh.load(bad)
    assert fresh.staging is None and not fresh.flat.any()
    loaded = verifier.CompiledVerifier(spec, 2, "cpu", "mxu")
    loaded.load(batch)
    staging, flat = loaded.staging.clone(), loaded.flat.clone()
    with pytest.raises(ValueError, match=match):
        loaded.load(bad)
    assert torch.equal(loaded.staging, staging)
    assert torch.equal(loaded.flat, flat)
