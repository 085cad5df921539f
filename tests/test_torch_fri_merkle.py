"""FRI's hash chains (``fri/merkle.py``) on the CPU, against the JAX
package's two scans and the port's own.

``merkle_roots_plain`` runs every leaf sponge and Merkle climb of a
verification time-step-major (one ``permute_plain`` a step over every chain
still running), the schedule of the chain kernels.  Each chain's root must
equal, bit for bit, what the JAX package's ``fri.verify._hash_leaves_scan``
then ``_merkle_chain`` give on the same numpy inputs (run as the JAX
package's own CPU e2e tests run them, with ``PLONKY2_TPU_HOST_MATH=1``: the
permutation is its Python-int reference), and what the port's copies of
those two scans give.  Inputs come from the fixtures or from numpy with a
seed; the query indices are random, since a root is a function of the data
and the index bits alone (that the plan's bit offsets are right against
real indices shows in the verdicts of ``tests/test_torch_verify.py``, whose
decode_block batch runs through ``merkle_roots``).  Limbs are integers, so
every comparison is exact: no tolerance applies.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_tpu.fri import verify as jfv
from plonky2_tpu_torch import verifier
from plonky2_tpu_torch.fri import merkle
from plonky2_tpu_torch.fri import verify as fv
from plonky2_tpu_torch.hash import poseidon_bn254 as pb
from plonky2_tpu_torch.kernels import build
from plonky2_tpu_torch.kernels import fri_merkle as kf
from plonky2_tpu_torch.kernels import poseidon_bn254 as kb
from plonky2_tpu_torch.kernels import launches
from plonky2_tpu_torch.proof import serde
from plonky2_tpu_torch.proof.fixtures import load_fixture
from plonky2_tpu_torch.proof.synthetic import make_dummy_proof, make_tiny_spec

torch.set_num_threads(1)
# the last two of decode_block's 28 query rounds: query shard 13 of 14
WINDOW = slice(26, 28)


@pytest.fixture
def host_math(monkeypatch):
    monkeypatch.setenv("PLONKY2_TPU_HOST_MATH", "1")


def _index(shape, bits, seed):
    """Random query indices below 2^bits as a GL pair of int64 words."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << bits, size=shape, dtype=np.uint64)
    return (torch.as_tensor((v & 0xFFFFFFFF).astype(np.int64)),
            torch.as_tensor((v >> 32).astype(np.int64)))


def _bits(x_index, offset, depth):
    return [(x_index[p >> 5] >> (p & 31)) & 1
            for p in range(offset, offset + depth)]


def _jax_roots(plan, dev, x_index):
    """The JAX scans: each kind's leaves through ``_hash_leaves_scan``, then
    the kinds of one (offset, depth) climbed together through
    ``_merkle_chain``, as the JAX verifier climbs its four initial oracles:
    (B, Q, len(plan), 16) int64."""
    digests = []
    for kind in plan:
        leaves = kind.leaves(dev).numpy().astype(np.uint32)
        digests.append(jfv._hash_leaves_scan(jnp.asarray(leaves),
                                             kind.slot_mask())
                       if kind.steps else jnp.asarray(leaves[:, :, 0, 0]))
    roots = dict(enumerate(digests))
    for offset, depth in {(k.offset, k.depth) for k in plan if k.depth}:
        group = [i for i, k in enumerate(plan)
                 if (k.offset, k.depth) == (offset, depth)]
        sibs = np.stack([plan[i].siblings(dev)[:, :, :depth].numpy()
                         for i in group], axis=2).astype(np.uint32)
        bits = [jnp.asarray(np.repeat(b.numpy()[..., None], len(group),
                                      axis=-1).astype(np.uint32))
                for b in _bits(x_index, offset, depth)]
        out = jfv._merkle_chain(jnp.stack([digests[i] for i in group], 2),
                                jnp.asarray(sibs), bits, depth)
        roots.update({i: out[:, :, g] for g, i in enumerate(group)})
    return torch.as_tensor(np.stack([np.asarray(roots[i])
                                     for i in range(len(plan))],
                                    axis=2).astype(np.int64))


def _port_roots(plan, dev, x_index):
    """The port's copies of the two scans, one kind at a time."""
    roots = []
    for kind in plan:
        if kind.steps:
            digest = fv._hash_leaves_scan(kind.leaves(dev), kind.slot_mask())
        else:
            digest = kind.leaves(dev)[:, :, 0, 0]
        roots.append(fv._merkle_chain(digest, kind.siblings(dev),
                                      _bits(x_index, kind.offset, kind.depth),
                                      kind.depth))
    return torch.stack(roots, dim=2)


@pytest.fixture(scope="module")
def decode_window():
    """decode_block at B=1, its last two query rounds as views of the
    whole batch (the 2-D mesh's last query shard), random indices."""
    spec, raw, vraw = load_fixture("testdata/decode_block")
    dev = verifier.proof_to_device(
        serde.stack_proofs([serde.ingest_proof(spec, raw, vraw)]), "cpu")
    keys = [k for k in serde.query_axis_keys(spec)
            if k.endswith(("leaf_packed", "siblings"))]
    window = {k: dev[k][:, WINDOW] for k in keys}
    x_index = _index((1, 2), spec.lde_bits, seed=5)
    return spec, window, x_index


@pytest.fixture(scope="module")
def tiny():
    """The tiny spec (noop oracles 2 and 3, cap height 0), B=3, Q=2."""
    spec = make_tiny_spec(num_query_rounds=2)
    batch = serde.stack_proofs([make_dummy_proof(spec, seed=s)
                                for s in range(3)])
    return spec, verifier.proof_to_device(batch, "cpu"), _index(
        (3, 2), spec.lde_bits, seed=6)


# Chain kinds off the circuits' layouts: a partial last block, an oracle's
# view of a shared tensor, a HashOrNoop kind, levels that read bits 29 to 33
# of the index (across its two 32-bit words), a kind of no level.
MASK3 = serde.absorb_slot_masks(20)  # 3 steps, the last absorbs 1 slot
ODD_PLAN = (
    merkle.ChainKind("partial", "leaf", None, 3, merkle._mask_bits(MASK3),
                     "sib", 3, 29),
    merkle.ChainKind("oracle1", "leaf2", 1, 2, merkle._mask_bits(
        np.ones((2, 3), bool)), "sib2", 4, 30),
    merkle.ChainKind("noop", "leaf2", 0, 0, 0, "sib2", 2, 31),
    merkle.ChainKind("leaf only", "leaf", None, 1, merkle._mask_bits(MASK3[:1]),
                     "sib", 0, 0),
)


def _random_dev(B, Q, seed):
    """Random canonical limbs (values below 2^253) for ODD_PLAN."""
    rng = np.random.default_rng(seed)

    def limbs(*shape):
        v = rng.integers(0, 1 << 16, size=(B, Q) + shape + (16,),
                         dtype=np.int64)
        v[..., 15] &= 0x1FFF
        return torch.as_tensor(v)

    return {"leaf": limbs(3, 3), "sib": limbs(3), "leaf2": limbs(2, 2, 3),
            "sib2": limbs(2, 4)}


def test_plan_of_the_step_circuit():
    spec, _, _ = load_fixture("testdata/step")
    plan = merkle.merkle_plan(spec)
    assert [k.name for k in plan] == ["oracle0", "oracle1", "oracle2",
                                      "oracle3", "step0", "step1"]
    assert [k.steps for k in plan] == [10, 16, 3, 2, 4, 4]
    assert [k.depth for k in plan] == [12, 12, 12, 12, 8, 4]
    assert [k.offset for k in plan] == [0, 0, 0, 0, 4, 8]
    assert sum(k.length for k in plan) == 99
    assert max(k.length for k in plan) == 28
    layout = serde.leaf_layout(spec)
    for o in range(4):
        assert np.array_equal(plan[o].slot_mask(),
                              layout.slot_mask[o, :layout.n_steps[o]])
    assert np.array_equal(plan[4].slot_mask(), serde.absorb_slot_masks(32))
    assert [plan[k].name for (k,) in merkle.slot_plan(plan)] == [
        "oracle1", "oracle0", "oracle2", "oracle3", "step0", "step1"]


def test_plan_of_the_tiny_spec_has_noop_oracles():
    plan = merkle.merkle_plan(make_tiny_spec())
    assert [k.steps for k in plan] == [1, 1, 0, 0, 1]
    assert [k.mask for k in plan[2:4]] == [0, 0]
    assert [k.offset for k in plan] == [0, 0, 0, 0, 1]


@pytest.fixture(scope="module")
def tiny_roots(tiny):
    spec, dev, x_index = tiny
    return merkle.merkle_roots_plain(merkle.merkle_plan(spec), dev, x_index)


@pytest.fixture(scope="module")
def window_roots(decode_window):
    spec, dev, x_index = decode_window
    return merkle.merkle_roots_plain(merkle.merkle_plan(spec), dev, x_index)


def test_tiny_spec_roots_match_the_jax_scans(tiny, tiny_roots, host_math):
    spec, dev, x_index = tiny
    plan = merkle.merkle_plan(spec)
    assert tiny_roots.shape == (3, 2, len(plan), 16)
    assert torch.equal(tiny_roots, _jax_roots(plan, dev, x_index))


def test_decode_block_window_roots_match_the_jax_scans(decode_window,
                                                       window_roots,
                                                       host_math):
    spec, dev, x_index = decode_window
    assert dev["init_leaf_packed"].storage_offset() > 0  # a view
    plan = merkle.merkle_plan(spec)
    assert window_roots.shape == (1, 2, 6, 16)
    assert torch.equal(window_roots, _jax_roots(plan, dev, x_index))


@pytest.fixture(scope="module")
def odd():
    """ODD_PLAN's inputs at B=2, Q=3 and their plain roots."""
    dev = _random_dev(2, 3, seed=11)
    x_index = _index((2, 3), 40, seed=12)
    return dev, x_index, merkle.merkle_roots_plain(ODD_PLAN, dev, x_index)


def test_odd_kinds_match_the_jax_and_port_scans(odd, host_math):
    dev, x_index, got = odd
    assert got.shape == (2, 3, 4, 16)
    assert torch.equal(got, _jax_roots(ODD_PLAN, dev, x_index))
    assert torch.equal(got, _port_roots(ODD_PLAN, dev, x_index))


def test_a_flipped_sibling_bit_moves_only_its_own_root(odd):
    """A sibling bit flipped in one lane of each kind with levels: only
    that lane's root of that kind moves."""
    dev, x_index, before = odd
    flipped = {k: v.clone() for k, v in dev.items()}
    want = torch.zeros(before.shape[:-1], dtype=torch.bool)
    for k, kind in enumerate(ODD_PLAN[:3]):
        b, q = k % 2, k
        kind.siblings(flipped)[b, q, kind.depth - 1, k] ^= 1 << k
        want[b, q, k] = True
    after = merkle.merkle_roots_plain(ODD_PLAN, flipped, x_index)
    assert torch.equal((after != before).any(-1), want)


def test_merkle_roots_on_the_cpu_launches_nothing(tiny):
    spec, dev, x_index = tiny
    plan = merkle.merkle_plan(spec)
    launches.reset()
    merkle.merkle_roots(plan, dev, x_index)
    assert not any(launches.read().values())
    for kernel in (kf.chains_a, kf.chains_cios):
        with pytest.raises(build.KernelError):
            kernel(plan, dev, x_index)


def _geometry(plan, lanes, form):
    """The launch geometry on an H100's 132 SMs."""
    return kf.launch_geometry(plan, lanes, form, 132)


def test_descriptor_reads_the_views_in_place(decode_window):
    spec, dev, x_index = decode_window
    plan = merkle.merkle_plan(spec)
    geo = _geometry(plan, 2, "a")
    _, (B, Q), words = kf.descriptor(plan, dev, x_index, geo)
    head, per = kf.HEAD, kf.KIND_WORDS
    assert (B, Q) == (1, 2)
    assert words[:4] == [6, 1, 2, 6]
    assert words[4:10] == [x_index[0].data_ptr(), *x_index[0].stride(),
                           x_index[1].data_ptr(), *x_index[1].stride()]
    assert words[10:13] == [geo.threads, geo.tpl, len(geo.types)]
    assert words[10:13] == [128, 2, 6]
    for k, kind in enumerate(plan):
        w = words[head + per * k:head + per * (k + 1)]
        leaves, sibs = kind.leaves(dev), kind.siblings(dev)
        assert w[0] == leaves.data_ptr() and w[1:5] == list(leaves.stride()[:4])
        assert w[5] == sibs.data_ptr() and w[6:9] == list(sibs.stride()[:3])
        assert w[9:13] == [kind.steps, kind.depth, kind.offset, k]
        assert w[13] % (1 << 64) | (w[14] % (1 << 64)) << 64 == kind.mask
    # a kind a type, longest first
    assert words[head + per * 6:] == [1, 1, 1, 0, 1, 2, 1, 3, 1, 4, 1, 5]


def test_descriptor_lists_the_packed_slot_types(decode_window):
    spec, dev, x_index = decode_window
    plan = merkle.merkle_plan(spec)
    geo = kf.Geometry("cios", merkle.slot_plan(plan, pack=True), 1,
                      kf.THREADS, 4)
    words = kf.descriptor(plan, dev, x_index, geo)[2]
    assert words[10:13] == [128, 1, 4]
    assert words[kf.HEAD + kf.KIND_WORDS * 6:] == [1, 1, 1, 0, 2, 2, 3,
                                                    2, 4, 5]


def test_descriptor_rejects_malformed_operands(decode_window):
    spec, dev, x_index = decode_window
    plan = merkle.merkle_plan(spec)
    geo = _geometry(plan, 2, "a")
    narrow = dict(dev, init_siblings=dev["init_siblings"].to(torch.int32))
    with pytest.raises(ValueError):
        kf.descriptor(plan, narrow, x_index, geo)
    short = dict(dev, step0_siblings=dev["step0_siblings"][:, :, :2])
    with pytest.raises(ValueError):
        kf.descriptor(plan, short, x_index, geo)
    with pytest.raises(ValueError):
        kf.descriptor(plan, dev, (x_index[0], x_index[1][:, :1]), geo)
    strided = dev["step1_siblings"].transpose(-1, -2).contiguous()
    limbs = dict(dev, step1_siblings=strided.transpose(-1, -2))
    with pytest.raises(ValueError):
        kf.descriptor(plan, limbs, x_index, geo)


# The slot packing (fri/merkle.slot_plan) on the circuits' plans, and the
# launch geometry (kernels/fri_merkle.launch_geometry) at the main path's
# sizes.
def _plan_of(name):
    if name == "tiny":
        return merkle.merkle_plan(make_tiny_spec())
    return merkle.merkle_plan(load_fixture(f"testdata/{name}")[0])


@pytest.mark.parametrize("name", ["step", "decode_block", "tiny"])
def test_slot_plan_runs_each_chain_once_within_the_longest(name):
    plan = _plan_of(name)
    longest = max(k.length for k in plan)
    for pack in (False, True):
        types = merkle.slot_plan(plan, pack)
        assert sorted(k for t in types for k in t) == list(range(len(plan)))
        assert all(merkle.slot_length(plan, t) <= longest for t in types)
        assert merkle.slot_plan(plan, pack) == types
        lengths = [plan[t[0]].length for t in types]
        assert lengths == sorted(lengths, reverse=True)
    assert all(len(t) == 1 for t in merkle.slot_plan(plan))


def test_slot_plan_packs_the_step_and_decode_block_kinds():
    step, db = _plan_of("step"), _plan_of("decode_block")
    assert merkle.slot_plan(step, True) == ((1,), (0,), (2, 4), (3, 5))
    assert [merkle.slot_length(step, t) for t in
            merkle.slot_plan(step, True)] == [28, 22, 27, 22]
    assert merkle.slot_plan(db, True) == ((1,), (0,), (2, 3), (4, 5))
    assert [merkle.slot_length(db, t) for t in
            merkle.slot_plan(db, True)] == [27, 21, 27, 18]


@pytest.mark.parametrize("case", [
    ("step", 256, "a", "a_lane", False, 1, 336),
    ("step", 256, "cios", "cios_lane", False, 1, 336),
    ("step", 128, "a", "a_pair", False, 2, 336),
    ("step", 128, "cios", "cios_lane", True, 1, 112),
    ("step", 51, "cios", "cios_group", False, 4, 270),
    ("decode_block", 4, "a", "a_pair", False, 2, 12),
    ("decode_block", 4, "cios", "cios_group", False, 4, 24),
])
def test_launch_geometry_of_the_main_path(case):
    name, B, form, kernel, packed, tpl, blocks = case
    plan = _plan_of(name)
    geo = _geometry(plan, B * 28, form)
    assert (geo.kernel, geo.types, geo.tpl, geo.threads, geo.blocks) == (
        kernel, merkle.slot_plan(plan, packed), tpl, kf.THREADS, blocks)
    assert geo == _geometry(plan, B * 28, form)
    if name == "step":  # 99 permutations a lane, the longest kind 28
        assert geo.fill(plan) == 99 / (len(geo.types) * 28)


def test_ring_matrices_swizzle_each_row_s_chunks():
    mats, ring = kb.round_matrices(), kf.ring_matrices()
    for r in (0, 1, 7, 8, 77, 127):
        for c in range(8):
            p = c ^ (r & 7)
            assert np.array_equal(ring[:, r, 16 * p:16 * p + 16],
                                  mats[:, r, 16 * c:16 * c + 16])


def _slot_roots(cases):
    """Plain torch over the packed schedule the chain kernels run, for each
    case (plan, tensor dict, query index, slot types): each slot type's
    lanes run its kinds' chains back to back, a chain's state starting over
    (zeros, or a HashOrNoop leaf) once the last wrote its root; at each
    slot step one ``permute_plain`` over every type still running, of
    every case.  Returns each case's roots."""
    slots = []  # [case, type, kind in type, its step, state]
    roots = [[None] * len(plan) for plan, *_ in cases]

    def start(c, k):
        plan, dev, x_index, _ = cases[c]
        st = torch.zeros(x_index[0].shape + (4, 16), dtype=torch.int64)
        if plan[k].steps == 0:
            st[..., 0, :] = plan[k].leaves(dev)[:, :, 0, 0]
        return st

    def settle(sl):
        c, t = sl[0], cases[sl[0]][3][sl[1]]
        plan = cases[c][0]
        while sl[2] < len(t) and sl[3] == plan[t[sl[2]]].length:
            roots[c][t[sl[2]]] = sl[4][..., 0, :]
            sl[2], sl[3] = sl[2] + 1, 0
            if sl[2] < len(t):
                sl[4] = start(c, t[sl[2]])

    for c, (plan, dev, x_index, types) in enumerate(cases):
        for i, t in enumerate(types):
            slots.append([c, i, 0, 0, start(c, t[0])])
            settle(slots[-1])
    while running := [sl for sl in slots
                      if sl[2] < len(cases[sl[0]][3][sl[1]])]:
        ins = []
        for c, i, j, step, st in running:
            plan, dev, x_index, types = cases[c]
            kind = plan[types[i][j]]
            ins.append(merkle._step_input(
                kind, st, step, dev, x_index,
                torch.as_tensor(kind.slot_mask())).reshape(-1, 4, 16))
        outs = pb.permute_plain(torch.cat(ins)).split(
            [t.shape[0] for t in ins])
        for sl, out in zip(running, outs):
            sl[4] = out.reshape(sl[4].shape)
            sl[3] += 1
            settle(sl)
    return [torch.stack(r, dim=2) for r in roots]


def test_slot_walk_matches_plain(tiny, tiny_roots, decode_window,
                                 window_roots):
    """The tiny spec with its noop oracles 2 and 3 (no absorb step) each
    behind another kind, and the decode_block window packed by
    ``slot_plan``, walked side by side."""
    spec, dev, x_index = tiny
    plan = merkle.merkle_plan(spec)
    w_spec, w_dev, w_index = decode_window
    w_plan = merkle.merkle_plan(w_spec)
    packed = merkle.slot_plan(w_plan, True)
    assert any(len(t) > 1 for t in packed)
    got = _slot_roots([(plan, dev, x_index, ((0, 2), (1, 3), (4,))),
                       (w_plan, w_dev, w_index, packed)])
    assert torch.equal(got[0], tiny_roots)
    assert torch.equal(got[1], window_roots)
