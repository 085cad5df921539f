"""The hand-written CUDA kernels against their plain torch versions, on the
card.  They need an NVIDIA GPU and ``nvcc``, so every test here carries the
``cuda`` marker and skips where ``torch.cuda.is_available()`` is false.  On a
machine with a GPU (``--noconftest``: the suite's conftest imports jax, which
a GPU machine need not have):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The arithmetic is modular and integer, so every comparison is exact
(``torch.equal``): no tolerance applies.
"""
import numpy as np
import pytest
import torch

from plonky2_tpu_torch.fields import bn254
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.fields import goldilocks_ext as qe
from plonky2_tpu_torch.fri import merkle
from plonky2_tpu_torch.fri.verify import _pow_ok
from plonky2_tpu_torch.hash import poseidon_bn254 as pb
from plonky2_tpu_torch.hash import poseidon_gl as pgl
from plonky2_tpu_torch.kernels import build
from plonky2_tpu_torch.kernels import fri_merkle as kf
from plonky2_tpu_torch.kernels import goldilocks_ext as kq
from plonky2_tpu_torch.kernels import poseidon_bn254 as kb
from plonky2_tpu_torch.kernels import poseidon_bn254_cios as kc
from plonky2_tpu_torch.kernels import poseidon_gl_transcript as kt
from plonky2_tpu_torch.proof import serde
from plonky2_tpu_torch.proof.spec import load_circuit_spec
from plonky2_tpu_torch.proof.synthetic import make_tiny_spec
from plonky2_tpu_torch.transcript import challenger as chal

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bn_states(shape, seed):
    """Canonical Montgomery limbs; the first state holds 0, 1, p-1, 2."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 16, size=shape + (4, 16), dtype=np.int64)
    vals[..., 15] &= 0x1FFF  # < 2^253 < p
    flat = vals.reshape(-1, 4, 16)
    flat[0] = [bn254.int_to_limbs(v) for v in (0, 1, bn254.P - 1, 2)]
    return torch.as_tensor(vals)


# Kernel A's blocks own 64 lanes: lane counts off that tile, its largest
# launch on the main path plus one, and the two launch sizes of a step batch
# split in two (two ranks of B=128, or two query shards): 3584 and 14336.
@pytest.mark.parametrize("shape", [(1,), (63,), (65,), (3, 2), (1000,),
                                   (3584,), (14336,), (28673,)])
def test_poseidon_bn254_kernel_matches_plain(dev, shape):
    st = _bn_states(shape, seed=len(shape) * 1000 + shape[0]).to(dev)
    before = kb.permute.launches
    got = kb.permute(st)
    assert kb.permute.launches == before + 1
    want = kb.permute_plain(st)
    torch.cuda.synchronize()
    assert got.shape == st.shape and torch.equal(got, want)


def test_poseidon_bn254_kernel_takes_strided_input(dev):
    st = _bn_states((5, 3), seed=7).to(dev).transpose(0, 1)
    assert not st.is_contiguous()
    assert torch.equal(kb.permute(st), kb.permute_plain(st.contiguous()))


def test_poseidon_bn254_kernel_rejects_other_dtypes(dev):
    with pytest.raises(ValueError):
        kb.permute(torch.zeros((2, 4, 16), dtype=torch.int32, device=dev))


# The CIOS kernel's group kernel owns 32 lanes a block (4 threads each), its
# lane kernel 128 (a thread each), and the launch switches from one to the
# other at 8448 lanes on the H100: lane counts off those tiles and off
# kernel A's, either side of the switch, the main path's two launch sizes,
# 7168 (leaf scans, FRI layers) and 28672 (Merkle levels), plus one, and
# those of a step batch split in two, 3584 (group kernel) and 14336 (lane
# kernel).
@pytest.mark.parametrize("shape", [(1,), (31,), (33,), (63,), (65,), (3, 2),
                                   (1000,), (3584,), (7168,), (8447,), (8448,),
                                   (14336,), (28673,)])
def test_poseidon_bn254_cios_kernel_matches_plain(dev, shape):
    st = _bn_states(shape, seed=len(shape) * 2000 + shape[0]).to(dev)
    before = kc.permute.launches
    got = kc.permute(st)
    assert kc.permute.launches == before + 1
    want = kc.permute_plain(st)
    torch.cuda.synchronize()
    assert got.shape == st.shape and torch.equal(got, want)


def test_poseidon_bn254_cios_kernel_takes_strided_input(dev):
    st = _bn_states((40, 25), seed=13).to(dev).transpose(0, 1)
    assert not st.is_contiguous()
    assert torch.equal(kc.permute(st), kc.permute_plain(st.contiguous()))


@pytest.mark.parametrize("edge", [0, 1, bn254.P - 1, 2])
def test_poseidon_bn254_cios_kernel_edge_values(dev, edge):
    """0, 1, p-1 and 2 in every element of a lane, beside a lane holding
    all four (the first state of ``_bn_states``)."""
    st = _bn_states((3,), seed=17)
    st[1] = torch.as_tensor([bn254.int_to_limbs(edge)] * 4)
    st = st.to(dev)
    assert torch.equal(kc.permute(st), kc.permute_plain(st))


def test_poseidon_bn254_cios_kernel_rejects_other_dtypes(dev):
    with pytest.raises(ValueError):
        kc.permute(torch.zeros((2, 4, 16), dtype=torch.int32, device=dev))


def test_permute_selects_the_kernel_by_env(dev, monkeypatch):
    st = _bn_states((4,), seed=11).to(dev)
    counts = (kb.permute.launches, kc.permute.launches)
    monkeypatch.setenv("PLONKY2_TPU_PB_IMPL", "cios")
    got_c = pb.permute(st)
    monkeypatch.setenv("PLONKY2_TPU_PB_IMPL", "mxu")
    got_a = pb.permute(st)
    assert (kb.permute.launches, kc.permute.launches) == (counts[0] + 1,
                                                         counts[1] + 1)
    assert torch.equal(got_c, got_a)


# Two proofs a block of the transcript kernel: odd batches leave a half
# block; 256 is the main path's batch.
@pytest.mark.parametrize("fixture", ["step", "decode_block"])
@pytest.mark.parametrize("batch", [1, 3, 17, 256, 257])
def test_transcript_kernel_matches_plain(dev, fixture, batch):
    spec = load_circuit_spec(f"testdata/{fixture}/common_circuit_data.json")
    schedule = chal.build_schedule(spec)
    rng = np.random.default_rng(3 + batch)
    obs = rng.integers(0, gl.P, size=(batch, schedule.n_obs), dtype=np.uint64)
    obs[0, :3] = [0, 1, gl.P - 1]
    pi = rng.integers(0, gl.P, size=(batch, 4), dtype=np.uint64)
    obs, pi = gl.split_u64(obs, dev), gl.split_u64(pi, dev)
    before = kt.run_transcript_kernel.launches
    got = chal.run_transcript(schedule, obs, pi)
    assert kt.run_transcript_kernel.launches == before + 1
    want = kt.run_transcript_plain(schedule, obs, pi)
    torch.cuda.synchronize()
    assert got[0].shape == (schedule.n_perms, batch, 12)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_gl_mul_chain_squares_in_goldilocks(dev):
    """The latency probe computes what it claims: x0^(2^n) mod p."""
    n = 1000
    got = int(kt.mul_chain(3, n, dev).item()) % (1 << 64)
    assert got == pow(3, pow(2, n, gl.P - 1), gl.P)


# -- the quadratic-extension chains and the public-input sponge ------------

GL_EDGE = [0, 1, gl.P - 1, (1 << 32) - 1, 1 << 32, gl.P - (1 << 32)]


def _qe_vals(shape, seed, zero_lanes=0):
    """Random QE values (c0, c1) as uint64 arrays; the first elements take
    every pair of GL_EDGE but (0, 0), the last ``zero_lanes`` are 0."""
    rng = np.random.default_rng(seed)
    c = [np.array(rng.integers(0, gl.P, size=shape, dtype=np.uint64))
         for _ in range(2)]
    f0, f1 = c[0].reshape(-1), c[1].reshape(-1)
    pairs = [(a, b) for a in GL_EDGE for b in GL_EDGE if a or b][:f0.size]
    for i, (a, b) in enumerate(pairs):
        f0[i], f1[i] = a, b
    if zero_lanes:
        f0[-zero_lanes:] = 0
        f1[-zero_lanes:] = 0
    return c


def _qe(vals, dev):
    return tuple(tuple(t.reshape(np.shape(v)) for t in gl.split_u64(v, dev))
                 for v in vals)


def _qe_equal(got, want):
    return all(g.shape == w.shape and torch.equal(g, w)
               for gc, wc in zip(got, want) for g, w in zip(gc, wc))


def _strided(a):
    """The same QE value through a transposed, non-contiguous view."""
    return tuple(tuple(t.T.contiguous().T for t in c) for c in a)


# (terms shape, x shape): the main path's horner calls at B=256 (step;
# decode_block's final polynomial is (B, 1, 16) and its FRI batch 257),
# lane counts off the 64-thread block, n = 1, and terms that broadcast.
QE_HORNER_CASES = [((256, 63), ()), ((256, 4, 4), ()), ((256, 145), (256,)),
                   ((256, 2, 8), (256, 1)), ((256, 258), (256,)),
                   ((256, 257), (256,)), ((256, 2), (256,)),
                   ((256, 1, 32), (256, 28)), ((256, 1, 16), (256, 28)),
                   ((1, 5), (1,)), ((31, 7), (31,)), ((33, 7), (33,)),
                   ((255, 9), (255,)), ((257, 9), (257,)), ((65, 1), (65,)),
                   ((1, 9), (40,))]


@pytest.mark.parametrize("shapes", QE_HORNER_CASES,
                         ids=[f"{t}-{x}" for t, x in QE_HORNER_CASES])
def test_qe_horner_kernel_matches_plain(dev, shapes):
    t_shape, x_shape = shapes
    terms = _qe(_qe_vals(t_shape, seed=sum(t_shape)), dev)
    x = _qe(_qe_vals(x_shape, seed=len(x_shape) + 1), dev)
    before = kq.horner.launches
    got = qe.horner(terms, x)
    assert kq.horner.launches == before + 1
    want = qe.horner_plain(terms, x)
    torch.cuda.synchronize()
    assert _qe_equal(got, want)


def test_qe_horner_kernel_takes_strided_input(dev):
    terms = _strided(_qe(_qe_vals((256, 145), seed=3), dev))
    x = _qe(_qe_vals((256,), seed=4), dev)
    assert not terms[0][0].is_contiguous()
    assert _qe_equal(kq.horner(terms, x), qe.horner_plain(terms, x))


@pytest.mark.parametrize("lanes,n", [(256, 258), (256, 257), (256, 2),
                                     (1, 5), (31, 5), (33, 5), (255, 9),
                                     (257, 9), (256, 1)])
def test_qe_powers_kernel_matches_plain(dev, lanes, n):
    x = _qe(_qe_vals((lanes,), seed=lanes + n), dev)
    before = kq.powers.launches
    got = qe.powers(x, n)
    assert kq.powers.launches == before + 1
    want = qe.powers_plain(x, n)
    torch.cuda.synchronize()
    assert _qe_equal(got, want)


# The split chains (G threads a lane, G from kq.chain_group): n at and around
# the group widths and a long chain, lane counts off the chains' blocks
# (whole warps, about lanes x G / 132 threads); x holds 0 in its last lane
# and 1 in lane 5 (the edge pairs of _qe_vals).
QE_SPLIT_CASES = [(256, 31), (256, 32), (256, 33), (256, 64), (256, 65),
                  (7, 1000), (7169, 32), (1023, 4), (257, 65)]


@pytest.mark.parametrize("lanes,n", QE_SPLIT_CASES)
def test_qe_chain_kernels_split_match_plain(dev, lanes, n):
    terms = _qe(_qe_vals((lanes, n), seed=lanes + 3 * n), dev)
    x = _qe(_qe_vals((lanes,), seed=lanes + n + 1, zero_lanes=1), dev)
    assert _qe_equal(qe.horner(terms, x), qe.horner_plain(terms, x))
    assert _qe_equal(qe.powers(x, n), qe.powers_plain(x, n))


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("lanes,n", [(256, 258), (7168, 32), (33, 65)])
def test_qe_chain_kernels_match_plain_at_every_group(dev, lanes, n, group):
    terms = _qe(_qe_vals((lanes, n), seed=n), dev)
    x = _qe(_qe_vals((lanes,), seed=n + 1, zero_lanes=1), dev)
    assert _qe_equal(kq.horner(terms, x, group=group),
                     qe.horner_plain(terms, x))
    assert _qe_equal(kq.powers(x, n, group=group), qe.powers_plain(x, n))


def test_qe_powers_kernel_takes_strided_input(dev):
    x = _qe(_qe_vals((16, 16), seed=9), dev)
    x = tuple(tuple(t.T for t in c) for c in x)
    assert not x[0][0].is_contiguous()
    assert _qe_equal(kq.powers(x, 6), qe.powers_plain(x, 6))


# The main path's inverses at B=256, lane counts off the 64-thread block;
# each with lanes of 0, which give 0.
@pytest.mark.parametrize("shape", [(256,), (256, 28), (256, 28, 16), (1,),
                                   (31,), (33,), (255,), (257,)])
def test_qe_inv_kernel_matches_plain(dev, shape):
    a = _qe(_qe_vals(shape, seed=int(np.prod(shape)), zero_lanes=1), dev)
    before = kq.inv.launches
    got = qe.inv(a)
    assert kq.inv.launches == before + 1
    want = qe.inv_plain(a)
    torch.cuda.synchronize()
    assert _qe_equal(got, want)
    assert all(int(t.reshape(-1)[-1]) == 0 for c in got for t in c)


def test_qe_inv_kernel_takes_strided_input(dev):
    a = _strided(_qe(_qe_vals((28, 256), seed=5), dev))
    assert not a[0][0].is_contiguous()
    assert _qe_equal(kq.inv(a), qe.inv_plain(a))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 36])
@pytest.mark.parametrize("batch", [1, 256])
def test_pi_hash_sponge_matches_plain(dev, n, batch):
    rng = np.random.default_rng(n + batch)
    vals = rng.integers(0, gl.P, size=(batch, n), dtype=np.uint64)
    flat = vals.reshape(-1)
    flat[:min(flat.size, 3)] = [0, 1, gl.P - 1][:flat.size]
    inputs = gl.split_u64(vals, dev)
    before = kt.hash_no_pad_kernel.launches
    got = pgl.hash_no_pad(inputs)
    assert kt.hash_no_pad_kernel.launches == before + (n > 0)
    want = pgl.hash_no_pad_plain(inputs)
    torch.cuda.synchronize()
    assert got[0].shape == (batch, 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- the PLONK stage's products and the interpolation scan ------------------

from plonky2_tpu_torch.gates import gates as G  # noqa: E402
from plonky2_tpu_torch.kernels import goldilocks_mul as km  # noqa: E402

# The main path's product shapes at B=256 (the largest: prod_axis's
# (256, 28, 16, 8) over the FRI openings, the (256, 28, 16) base products),
# and lane counts off the 128-thread block.
PRODUCT_SHAPES = [(256,), (256, 28), (256, 80), (256, 4, 12), (256, 28, 16),
                  (256, 28, 16, 8), (1,), (31,), (33,), (255,), (257,)]


def _gl(vals, dev):
    return tuple(t.reshape(np.shape(vals)) for t in gl.split_u64(vals, dev))


def _gl_vals(shape, seed):
    return _qe_vals(shape, seed)[0]


def _counted(counter, fn):
    """fn() and the launches it added to ``counter``'s wrapper."""
    before = counter.launches
    out = fn()
    return out, counter.launches - before


@pytest.mark.parametrize("shape", PRODUCT_SHAPES)
def test_gl_mul_kernel_matches_plain(dev, shape):
    a = _gl(_gl_vals(shape, seed=11), dev)
    b = _gl(_gl_vals(shape, seed=12), dev)
    got, n = _counted(km.gl_mul, lambda: gl.mul(a, b))
    want = gl.mul_plain(a, b)
    torch.cuda.synchronize()
    assert n == 1 and all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("shape", PRODUCT_SHAPES)
def test_qe_mul_and_mul_add_kernels_match_plain(dev, shape):
    a, b, c = (_qe(_qe_vals(shape, seed=s), dev) for s in (13, 14, 15))
    got, n = _counted(km.qe_mul, lambda: qe.mul(a, b))
    got_add, n_add = _counted(km.qe_mul, lambda: qe.mul_add(a, b, c))
    want, want_add = qe.mul_plain(a, b), qe.mul_add_plain(a, b, c)
    torch.cuda.synchronize()
    assert (n, n_add) == (1, 1)
    assert _qe_equal(got, want) and _qe_equal(got_add, want_add)


@pytest.mark.parametrize("c", [0, 1, 7, gl.DTH_ROOT, gl.P - 1])
@pytest.mark.parametrize("shape", [(256, 44), (257,)])
def test_gl_mul_const_kernel_matches_plain(dev, c, shape):
    a = _gl(_gl_vals(shape, seed=16), dev)
    got, n = _counted(km.gl_mul_const, lambda: gl.mul_const(a, c))
    want = gl.mul_const_plain(a, c)
    torch.cuda.synchronize()
    assert n == (c not in (0, 1))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if c == 1:
        assert got is a


def _views(dev):
    """(name, a, b) QE operands of each broadcast pattern of the call sites
    at B=256, views as the call sites make them."""
    def v(shape, seed):
        return _qe(_qe_vals(shape, seed), dev)

    wires = v((256, 135), 20)
    pairs = v((256, 28, 16), 21)
    return [
        ("column x row", v((256, 1), 22), v((256, 80), 23)),
        ("table x rows", v((80,), 24), v((256, 80), 25)),
        ("(B, k, 1) x (B, k, n)", v((256, 28, 1), 26), v((256, 28, 16), 27)),
        ("scalar x rows", v((), 28), v((256, 80), 29)),
        ("wire columns", qe.index(wires, (Ellipsis, 3)),
         qe.index(wires, (Ellipsis, 100))),
        ("wire slices", qe.index(wires, (Ellipsis, slice(1, 81, 4))),
         qe.index(wires, (Ellipsis, slice(2, 82, 4)))),
        ("even x odd columns", qe.index(pairs, (Ellipsis, slice(0, None, 2))),
         qe.index(pairs, (Ellipsis, slice(1, None, 2)))),
        ("transposed", _strided(v((256, 80), 30)), v((256, 80), 31)),
        ("empty", v((256, 0), 32), v((256, 0), 33)),
    ]


def test_product_kernels_read_broadcast_and_strided_operands(dev):
    for name, a, b in _views(dev):
        lead = torch.broadcast_shapes(a[0][0].shape, b[0][0].shape)
        c = _qe(_qe_vals(tuple(lead), seed=34), dev)
        launched = int(lead.numel() > 0)
        got, n = _counted(km.qe_mul, lambda: qe.mul(a, b))
        got_add, n_add = _counted(km.qe_mul, lambda: qe.mul_add(a, b, c))
        got_gl, n_gl = _counted(km.gl_mul, lambda: gl.mul(a[0], b[1]))
        torch.cuda.synchronize()
        assert (n, n_add, n_gl) == (launched,) * 3, name
        assert _qe_equal(got, qe.mul_plain(a, b)), name
        assert _qe_equal(got_add, qe.mul_add_plain(a, b, c)), name
        want_gl = gl.mul_plain(a[0], b[1])
        assert all(g.shape == w.shape and torch.equal(g, w)
                   for g, w in zip(got_gl, want_gl)), name


def _cpu(x):
    return torch.utils._pytree.tree_map(lambda t: t.cpu(), x)


def _coset_gate(fixture):
    spec = load_circuit_spec(f"testdata/{fixture}/common_circuit_data.json")
    gate, = [g for g in spec.gates() if isinstance(g, G.CosetInterpolationGate)]
    return gate


def _scan_case(case, lanes, dev, seed=0):
    """The scan's arguments on ``dev`` (random EA values, lanes 0 to 5
    holding the edge values in every coordinate, lanes 6 to 8 a point equal
    to a domain point: a zero t) and the host schedule
    (``test_torch_coset_scan.scan_inputs``)."""
    from test_torch_coset_scan import scan_inputs, torch_ea
    coords, schedule = scan_inputs(case, lanes, seed)
    args = tuple(torch_ea(c) for c in coords)
    return _on(args, dev), schedule


def _on(x, dev):
    return torch.utils._pytree.tree_map(lambda t: t.to(dev), x)


def _scan_plain(args, schedule):
    """The plain scan on CPU copies (on the card its products would go
    through the product kernels)."""
    return G.coset_interp_scan_plain(
        *G.coset_interp_scan_operands(*_cpu(args), schedule))


def _leaves_equal(got, want):
    leaves = torch.utils._pytree.tree_leaves
    return all(g.shape == w.shape and torch.equal(g.cpu(), w.cpu())
               for g, w in zip(leaves(got), leaves(want)))


# Both fixtures' gate at the main path's 256 lanes and lane counts off the
# 64-thread block (8 segments of 8); a gate of degree 5, gates of one chunk
# (degree 8; degree 32, a segment of a whole warp), a schedule of degree 1
# and one whose mask is not a prefix.
SCAN_CASES = ([(f, n) for f in ("step", "decode_block")
               for n in (256, 1, 31, 33, 255, 257)]
              + [(c, n) for c in ("gate-4-5", "gate-3-8", "gate-5-32", "deg1",
                                  "deg3-mask") for n in (9, 257)])


@pytest.mark.parametrize("case, lanes", SCAN_CASES)
def test_coset_interp_scan_kernel_matches_plain(dev, case, lanes):
    args, schedule = _scan_case(case, lanes, dev)
    got, n = _counted(km.coset_interp_scan,
                      lambda: G.coset_interp_scan(*args, schedule))
    want = _scan_plain(args, schedule)
    torch.cuda.synchronize()
    assert n == 1 and _leaves_equal(got, want)


@pytest.mark.parametrize("fixture", ["step", "decode_block"])
def test_coset_interp_scan_kernel_reads_views_as_contiguous_copies(dev,
                                                                   fixture):
    """The gate's operands are views of wire columns (every other column,
    a column broadcast over the chunks) and a transposed view: the same
    outputs as contiguous copies."""
    gate = _coset_gate(fixture)
    ni, n = gate.num_intermediates, gate.num_points
    wires = _qe(_qe_vals((256, 135), seed=52), dev)
    cols = G._ea_cols
    inter_eval, inter_prod = cols(wires, 37, ni), cols(wires, 41, ni)
    values = (_strided(cols(wires, 1, n)[0]), cols(wires, 1, n)[1])
    pt = tuple(qe.index(c, (Ellipsis, slice(45, 46))) for c in (wires, wires))
    args = (inter_eval, inter_prod, values, pt)
    dense = torch.utils._pytree.tree_map(lambda t: t.contiguous(), args)
    assert not values[0][0][0].is_contiguous()
    got = km.coset_interp_scan(*args, gate.schedule)
    want = km.coset_interp_scan(*dense, gate.schedule)
    torch.cuda.synchronize()
    assert _leaves_equal(got, want)
    assert _leaves_equal(got, _scan_plain(args, gate.schedule))


def test_coset_interp_scan_kernel_is_captured_in_a_graph(dev):
    """Captured once, the launch replays on new values written into its
    inputs, with the schedule it was captured with."""
    gate = _coset_gate("step")
    args, schedule = _scan_case("step", 256, dev, seed=1)
    fresh, _ = _scan_case("step", 256, dev, seed=2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        km.coset_interp_scan(*args, gate.schedule)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = km.coset_interp_scan(*args, gate.schedule)
    leaves = torch.utils._pytree.tree_leaves
    for t, f in zip(leaves(args), leaves(fresh)):
        t.copy_(f)
    graph.replay()
    torch.cuda.synchronize()
    assert _leaves_equal(out, _scan_plain(fresh, schedule))


def test_coset_interp_scan_kernel_checks_its_operands(dev):
    args, schedule = _scan_case("step", 4, dev)
    inter_eval, inter_prod, values, pt = args
    narrow = ((values[0][0][0].int(), values[0][0][1]), values[0][1])
    with pytest.raises(ValueError):
        km.coset_interp_scan(inter_eval, inter_prod, (narrow, values[1]), pt,
                             schedule)
    with pytest.raises(ValueError):  # planes on two devices
        km.coset_interp_scan(inter_eval, _cpu(inter_prod), values, pt,
                             schedule)
    with pytest.raises(ValueError):  # a value column past the values
        km.coset_interp_scan(inter_eval, inter_prod,
                             _on(tuple(qe.index(c, (Ellipsis, slice(0, 8)))
                                       for c in values), dev), pt, schedule)
    empty = _on(torch.utils._pytree.tree_map(lambda t: t[:0], args), dev)
    out, n = _counted(km.coset_interp_scan,
                      lambda: km.coset_interp_scan(*empty, schedule))
    assert n == 0 and out[0][0][0][0].shape == (0, 3)


@pytest.mark.parametrize("fixture", ["step", "decode_block"])
def test_coset_gate_on_the_card_matches_the_cpu(dev, fixture):
    """The whole gate, its products and scan on the card, against the gate
    on CPU copies of the same wires (B=256)."""
    gate = _coset_gate(fixture)
    wires = _qe(_qe_vals((256, 135), seed=50), dev)
    consts = _qe(_qe_vals((256, 2), seed=51), dev)
    pih = gl.zeros((256, 4), dev)
    got, n = _counted(km.coset_interp_scan,
                      lambda: gate.eval(consts, wires, pih))
    want = gate.eval(_cpu(consts), _cpu(wires), _cpu(pih))
    torch.cuda.synchronize()
    assert n == 1 and _qe_equal(_cpu(got), want)


# -- the batch inverse and the bit-selected product by a constant -----------

def _inv_zeros(n):
    """0 at the first element, lane 31, the last, and from 512 elements on
    all of [256, 512): a whole warp at every K elements a thread."""
    zeros = {0, min(31, n - 1), n - 1}
    if n >= 512:
        zeros.update(range(256, 512))
    return sorted(zeros)


def _inv_vals(shape, seed):
    vals = _qe_vals(shape, seed)
    for v in vals:
        v.reshape(-1)[_inv_zeros(v.size)] = 0
    return vals


# Element counts around a warp's 32 K elements, and the main path's
# largest; the inverse at every K and at the wrapper's own.
@pytest.mark.parametrize("k", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 255, 257, 7168])
def test_qe_inv_kernel_batch_matches_plain(dev, n, k):
    a = _qe(_inv_vals((n,), seed=n), dev)
    got, launched = _counted(kq.inv, lambda: kq.inv(a, per_thread=k))
    want = qe.inv_plain(a)
    torch.cuda.synchronize()
    assert launched == 1 and _qe_equal(got, want)
    zeros = torch.as_tensor(_inv_zeros(n), device=dev)
    assert not any(t[zeros].any() for c in got for t in c)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_qe_inv_kernel_at_the_largest_main_path_shape(dev, k):
    a = _qe(_inv_vals((256, 28, 16), seed=k), dev)
    assert _qe_equal(kq.inv(a, per_thread=k), qe.inv_plain(a))


def _views_qe(dev):
    """(name, strided or broadcast QE value) at the inverse's shapes."""
    def v(shape, seed):
        return _qe(_qe_vals(shape, seed), dev)

    return [
        ("transposed", _strided(v((28, 256), 60))),
        ("broadcast", tuple(tuple(t.expand(256, 28, 16) for t in c)
                            for c in v((256, 28, 1), 61))),
        ("even columns", tuple(tuple(t[..., ::2] for t in c)
                               for c in v((256, 28, 32), 62))),
    ]


@pytest.mark.parametrize("view", range(3))
def test_qe_inv_kernel_reads_views_as_contiguous_copies(dev, view):
    name, a = _views_qe(dev)[view]
    dense = tuple(tuple(t.contiguous() for t in c) for c in a)
    got = kq.inv(a)
    assert _qe_equal(got, kq.inv(dense)), name
    assert _qe_equal(got, qe.inv_plain(a)), name


def test_qe_chain_kernels_read_broadcast_operands_in_place(dev):
    """x and the terms broadcast (stride 0) and sliced, against contiguous
    copies: the chains read every operand where it lies."""
    terms = _qe(_qe_vals((256, 1, 32), seed=63), dev)
    x = _qe(_qe_vals((256, 28), seed=64), dev)
    wide = tuple(tuple(t.expand(256, 28, 32).contiguous() for t in c)
                 for c in terms)
    assert _qe_equal(kq.horner(terms, x), kq.horner(wide, x))
    terms = _qe(_qe_vals((256, 290), seed=65), dev)
    sliced = tuple(tuple(t[:, 1:259] for t in c) for c in terms)
    scalar = _qe(_qe_vals((), seed=66), dev)
    dense = tuple(tuple(t.contiguous() for t in c) for c in sliced)
    full = tuple(tuple(t.expand(256).contiguous() for t in c) for c in scalar)
    assert _qe_equal(kq.horner(sliced, scalar), kq.horner(dense, full))
    assert _qe_equal(kq.horner(sliced, scalar), qe.horner_plain(dense, full))
    x = _qe(_qe_vals((2, 256), seed=67), dev)
    row = tuple(tuple(t[1] for t in c) for c in x)
    assert _qe_equal(kq.powers(row, 33), kq.powers(
        tuple(tuple(t.contiguous() for t in c) for c in row), 33))


def _index(shape, bits, seed, dev):
    rng = np.random.default_rng(seed)
    top = gl.P if bits == 64 else 1 << bits
    v = np.array(rng.integers(0, top, size=shape, dtype=np.uint64))
    v.reshape(-1)[:min(3, v.size)] = [0, 1, top - 1][:min(3, v.size)]
    return _gl(v, dev)


def _step_bits_calls():
    """FRI's bit-selected products at step: (name, a given, c, off, table)."""
    spec = load_circuit_spec("testdata/step/common_circuit_data.json")
    lde = spec.lde_bits
    calls = [("subgroup_x", False, gl.MULTIPLICATIVE_GROUP_GENERATOR, 0,
              gl.bitrev_powers(gl.primitive_root_of_unity(lde), lde))]
    off = 0
    for j, bits in enumerate(spec.reduction_arity_bits):
        g_inv = pow(gl.primitive_root_of_unity(bits), (1 << bits) - 1, gl.P)
        calls.append((f"cosetStart {j}", True, 1, off,
                      gl.bitrev_powers(g_inv, bits)))
        off += bits
    return spec, calls


def _bits_equal(got, want):
    return all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(got, want))


@pytest.mark.parametrize("call", range(3))
@pytest.mark.parametrize("lanes", [256 * 28, 1, 31, 33, 255, 257])
def test_mul_const_bits_kernel_matches_plain_at_fri_calls(dev, lanes, call):
    spec, calls = _step_bits_calls()
    _, has_a, c, off, table = calls[call]
    idx = _index((lanes,), spec.lde_bits, seed=lanes + call, dev=dev)
    a = _gl(_gl_vals((lanes,), seed=70 + call), dev) if has_a else None
    got, n = _counted(km.gl_mul_const,
                      lambda: gl.mul_const_bits(a, c, idx, off, table))
    want = gl.mul_const_bits_plain(a, c, idx, off, table)
    torch.cuda.synchronize()
    assert n == 1 and _bits_equal(got, want)


@pytest.mark.parametrize("off,bits", [(0, 64), (48, 16), (3, 5), (63, 1),
                                      (0, 1)])
@pytest.mark.parametrize("c", [0, 1, 7, gl.DTH_ROOT])
def test_mul_const_bits_kernel_takes_any_bits_of_64_bit_indices(dev, off,
                                                               bits, c):
    rng = np.random.default_rng(off + bits)
    table = [int(t) for t in rng.integers(0, gl.P, size=bits,
                                          dtype=np.uint64)]
    idx = _index((257,), 64, seed=off, dev=dev)
    a = _gl(_gl_vals((257,), seed=bits), dev)
    for x in (a, None):
        got = gl.mul_const_bits(x, c, idx, off, table)
        assert _bits_equal(got, gl.mul_const_bits_plain(x, c, idx, off,
                                                        table))


def test_mul_const_bits_kernel_reads_views_as_contiguous_copies(dev):
    _, calls = _step_bits_calls()
    _, _, c, off, table = calls[2]
    idx = tuple(t.T for t in _index((28, 256), 16, seed=80, dev=dev))
    a = tuple(t.T for t in _gl(_gl_vals((28, 256), seed=81), dev))
    dense = (tuple(t.contiguous() for t in a),
             tuple(t.contiguous() for t in idx))
    got = gl.mul_const_bits(a, c, idx, off, table)
    assert _bits_equal(got, gl.mul_const_bits(dense[0], c, dense[1], off,
                                              table))
    assert _bits_equal(got, gl.mul_const_bits_plain(a, c, idx, off, table))
    col = _gl(_gl_vals((256, 1), seed=82), dev)
    got = gl.mul_const_bits(col, 5, idx, 0, table)
    assert got[0].shape == (256, 28)
    assert _bits_equal(got, gl.mul_const_bits_plain(col, 5, idx, 0, table))
    empty = _index((256, 0), 16, seed=83, dev=dev)
    got, n = _counted(km.gl_mul_const,
                      lambda: gl.mul_const_bits(None, 7, empty, 0, table))
    assert n == 0 and got[0].shape == (256, 0)


# (pow response, pow_bits, verdict) in each branch of 64 - pow_bits (24,
# 32, 48, 64): tests/test_torch_serde_negative.py's cases, held there
# against the JAX function
POW_CASES = [((1 << 24) - 1, 40, True), (1 << 24, 40, False),
             (1 << 35, 40, False), ((1 << 32) - 1, 32, True),
             (1 << 32, 32, False), ((1 << 48) - 1, 16, True),
             (1 << 48, 16, False), (123, 16, True),
             ((1 << 63) + 5, 0, True)]


@pytest.mark.parametrize("pow_bits", sorted({b for _, b, _ in POW_CASES}))
def test_pow_ok_on_a_cuda_tensor(dev, pow_bits):
    cases = [(v, want) for v, b, want in POW_CASES if b == pow_bits]
    pr = gl.split_u64(np.array([v for v, _ in cases], np.uint64), dev)
    got = _pow_ok(pr, pow_bits)
    assert got.device == pr[0].device
    assert got.cpu().tolist() == [want for _, want in cases]


# FRI's chain kernels (csrc/fri_merkle.cu) against merkle_roots_plain on the
# card: random canonical limbs in the step circuit's layout at B=2 (336
# chains: kernel A's pair form, the CIOS group form), B=51 (8568 chains,
# 1428 lanes a kind, ragged blocks), B=97 (16,296: the CIOS lane form with
# the kinds packed, two kinds back to back in a lane slot), B=256 (the main
# path's 43,008: both lane forms), the tiny spec (noop oracles, cap height
# 0) and a query window's views; a lane of garbage limbs computes its own
# root and no other lane's.
def _chain_dev(spec, B, Q, seed, dev):
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, _) in serde.proof_shapes(spec, Q).items():
        if k.endswith(("leaf_packed", "siblings")):
            v = rng.integers(0, 1 << 16, size=(B,) + shape, dtype=np.int64)
            v[..., 15] &= 0x1FFF  # < 2^253 < p
            out[k] = torch.as_tensor(v).to(dev)
    return out


def _chain_index(B, Q, bits, seed, dev):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << bits, size=(B, Q), dtype=np.uint64)
    return (torch.as_tensor((v & 0xFFFFFFFF).astype(np.int64)).to(dev),
            torch.as_tensor((v >> 32).astype(np.int64)).to(dev))


def _chain_case(name, dev, seed=90):
    if name == "tiny":
        spec, B, Q = make_tiny_spec(num_query_rounds=3), 5, 3
    else:
        spec = load_circuit_spec("testdata/step/common_circuit_data.json")
        B, Q = {"step B=2": (2, 28), "step B=51": (51, 28),
                "step B=97": (97, 28), "step B=256": (256, 28)}[name]
    return (merkle.merkle_plan(spec), _chain_dev(spec, B, Q, seed, dev),
            _chain_index(B, Q, spec.lde_bits, seed + 1, dev))


CHAIN_KERNELS = {"a": kf.chains_a, "cios": kf.chains_cios}


@pytest.mark.parametrize("form", sorted(CHAIN_KERNELS))
@pytest.mark.parametrize("case", ["step B=2", "step B=51", "step B=97",
                                  "step B=256", "tiny"])
def test_merkle_chain_kernel_matches_plain(dev, case, form):
    plan, d, x = _chain_case(case, dev)
    kernel = CHAIN_KERNELS[form]
    got, n = _counted(kernel, lambda: kernel(plan, d, x))
    want = merkle.merkle_roots_plain(plan, d, x)
    torch.cuda.synchronize()
    assert n == 1 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("form", sorted(CHAIN_KERNELS))
def test_merkle_chain_kernel_reads_a_query_window_in_place(dev, form):
    plan, d, x = _chain_case("step B=2", dev)
    window = {k: v[:, 20:27] for k, v in d.items()}
    xw = tuple(t[:, 20:27] for t in x)
    assert not window["init_siblings"].is_contiguous()
    got = CHAIN_KERNELS[form](plan, window, xw)
    dense = {k: v.contiguous() for k, v in window.items()}
    want = merkle.merkle_roots_plain(plan, dense,
                                     tuple(t.contiguous() for t in xw))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("form", sorted(CHAIN_KERNELS))
def test_merkle_chain_kernel_keeps_a_garbage_lane_to_itself(dev, form):
    plan, d, x = _chain_case("step B=2", dev)
    want = merkle.merkle_roots_plain(plan, d, x)
    bad = {k: v.clone() for k, v in d.items()}
    for v in bad.values():
        v[1, 5] = 0xFFFF  # limbs of 2^256 - 1: not a field element
    got = CHAIN_KERNELS[form](plan, bad, x)
    torch.cuda.synchronize()
    moved = (got != want).any(-1)
    assert moved[1, 5].all() and moved.sum() == len(plan)


@pytest.mark.parametrize("form", sorted(CHAIN_KERNELS))
def test_merkle_chain_kernel_is_captured_in_a_graph(dev, form):
    """Captured once, the launch replays on new limbs written into its
    inputs."""
    plan, d, x = _chain_case("step B=2", dev)
    _, fresh, fresh_x = _chain_case("step B=2", dev, seed=92)
    kernel = CHAIN_KERNELS[form]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = kernel(plan, d, x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernel(plan, d, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    for k in d:
        d[k].copy_(fresh[k])
    for t, f in zip(x, fresh_x):
        t.copy_(f)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, merkle.merkle_roots_plain(plan, fresh, fresh_x))


# The layout each case launches on the card (kernels/fri_merkle
# .launch_geometry): the compiled kernel and whether the kinds are packed.
CHAIN_LAYOUTS = {("step B=2", "a"): ("a_pair", False),
                 ("step B=2", "cios"): ("cios_group", False),
                 ("step B=97", "a"): ("a_pair", False),
                 ("step B=97", "cios"): ("cios_lane", True),
                 ("step B=256", "a"): ("a_lane", False),
                 ("step B=256", "cios"): ("cios_lane", False)}


@pytest.mark.parametrize("case, form", sorted(CHAIN_LAYOUTS))
def test_merkle_chain_layout_on_the_card(dev, case, form):
    """Each form's layout at the cases the kernel test runs, and the
    compiled kernels' registers: kernel A's forms and the CIOS group form
    spill nothing."""
    plan, _, x = _chain_case(case, dev)
    B, Q = x[0].shape
    geo = kf.geometry(plan, B * Q, form, dev)
    kernel, packed = CHAIN_LAYOUTS[case, form]
    assert geo.kernel == kernel
    assert geo.types == merkle.slot_plan(plan, pack=packed)
    lim = kf.limits(dev, geo.kernel, geo.threads)
    assert lim["resident"] >= 1 and lim["max_threads"] >= geo.threads
    if kernel != "cios_lane":
        assert lim["spill_bytes"] == 0
    assert geo.blocks == len(geo.types) * -(-B * Q * geo.tpl // geo.threads)


def test_merkle_roots_dispatches_by_the_kernel_setting(dev):
    plan, d, x = _chain_case("tiny", dev)
    want = merkle.merkle_roots_plain(plan, d, x)
    for impl, kernel in (("mxu", kf.chains_a), ("cios", kf.chains_cios)):
        with pb.use_impl(impl):
            got, n = _counted(kernel, lambda: merkle.merkle_roots(plan, d, x))
        assert n == 1 and torch.equal(got, want)
    with pytest.raises(ValueError):  # siblings on another device
        kf.chains_a(plan, dict(d, init_siblings=d["init_siblings"].cpu()), x)
    with pytest.raises(build.KernelError):  # the index on the CPU
        kf.chains_a(plan, d, tuple(t.cpu() for t in x))


# FRI's leaf-block builder (csrc/fri_leaves.cu) against the plain version
# (fri/merkle.leaf_blocks_plain, run on the card too): full-range 64-bit
# words in the step circuit's layout at B=256 (every block of the main
# path's largest batch) and a query window of it (views read in place),
# decode_block at B=4 and the tiny spec (HashOrNoop oracles, one-block
# leaves); and the fixtures' ingested blocks; and a capture in a graph.
from plonky2_tpu_torch import verifier  # noqa: E402
from plonky2_tpu_torch.kernels import fri_leaves as kl  # noqa: E402
from plonky2_tpu_torch.proof.fixtures import decode_block_lanes  # noqa: E402
from plonky2_tpu_torch.proof.convert import from_reference  # noqa: E402


def _leaf_dev(spec, B, seed, dev):
    rng = np.random.default_rng(seed)
    batch = serde.zero_batch(spec, B)
    for k in batch:
        if k.startswith("init_leaves_") or k.endswith("_evals"):
            batch[k] = rng.integers(0, 1 << 64, size=batch[k].shape,
                                    dtype=np.uint64)
    return from_reference(batch, dev)


def _leaf_case(name, dev, seed=70):
    if name == "tiny":
        spec = make_tiny_spec(num_query_rounds=3)
        return spec, _leaf_dev(spec, 5, seed, dev)
    if name == "decode_block B=4":
        spec = load_circuit_spec(
            "testdata/decode_block/common_circuit_data.json")
        return spec, _leaf_dev(spec, 4, seed, dev)
    step = load_circuit_spec("testdata/step/common_circuit_data.json")
    d = _leaf_dev(step, 256, seed, dev)
    if name == "step B=256 window":
        qkeys = set(serde.query_axis_keys(step))

        def cut(t):
            return tuple(cut(x) for x in t) if isinstance(t, tuple) \
                else t[:, 7:14]
        d = {k: (cut(v) if k in qkeys else v) for k, v in d.items()}
    return step, d


@pytest.mark.parametrize("case", ["step B=256", "step B=256 window",
                                  "decode_block B=4", "tiny"])
def test_leaf_block_kernel_matches_plain(dev, case):
    spec, d = _leaf_case(case, dev)
    got, n = _counted(kl.leaf_blocks, lambda: merkle.leaf_blocks(spec, d))
    want = merkle.leaf_blocks_plain(spec, d)
    torch.cuda.synchronize()
    assert n == 1 and sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].is_contiguous(), k
        assert torch.equal(got[k], want[k]), k


def test_leaf_block_kernel_equals_ingest(dev):
    spec, raws, vraw = decode_block_lanes("testdata/decode_block")
    batch = serde.stack_proofs([serde.ingest_proof(spec, r, vraw)
                                for r in raws])
    got = kl.leaf_blocks(spec, from_reference(batch, dev))
    torch.cuda.synchronize()
    for k, v in got.items():
        assert torch.equal(v.cpu(), torch.as_tensor(batch[k].astype(
            np.int64))), k


def test_leaf_block_kernel_is_captured_in_a_graph(dev):
    """Captured once, the launch replays on new words written into its
    inputs."""
    spec, d = _leaf_case("decode_block B=4", dev)
    _, fresh = _leaf_case("decode_block B=4", dev, seed=73)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kl.leaf_blocks(spec, d)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kl.leaf_blocks(spec, d)
    for (_, t), (_, f) in zip(verifier._leaves(d), verifier._leaves(fresh)):
        t.copy_(f)
    graph.replay()
    torch.cuda.synchronize()
    want = merkle.leaf_blocks_plain(spec, fresh)
    for k in want:
        assert torch.equal(out[k], want[k]), k

