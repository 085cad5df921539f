"""The PLONK stage's field arithmetic, which the port runs on the card as the
CUDA kernels of ``kernels/goldilocks_mul.py``: the plain versions (the CPU
path of each public function) against the JAX package's functions on the
same inputs, the wrappers' broadcast layout, and their contract on the CPU.

- ``goldilocks.mul_plain`` / ``mul_const_plain`` and
  ``goldilocks_ext.mul_plain`` / ``mul_add_plain`` against
  ``plonky2_tpu.fields.goldilocks.mul`` / ``mul_const`` and
  ``plonky2_tpu.fields.goldilocks_ext.mul`` / ``mul_add``, at the call
  sites' broadcast shapes and strided views (B=3), with every pair of the
  edge values 0, 1, p-1, 2^32-1, 2^32 and p-2^32;
- ``gates.coset_interp_scan_plain``, and the scan kernel's order
  (``test_torch_coset_scan.segment_scan``), through
  ``CosetInterpolationGate(4, 6, weights).eval``, against the JAX gate's
  ``eval`` (whose chunk steps are a ``jax.lax.scan``) on the same wires,
  with the step fixture's barycentric weights and the test vector's;
- ``goldilocks_mul.broadcast_layout``, a pure function, on each broadcast
  pattern of the call sites: the elements it addresses are those of
  ``torch.broadcast_to``;
- on CPU tensors the public functions launch nothing, the wrappers raise
  ``KernelError``, and a tensor on another device never reaches a plain
  version.

The arithmetic is modular and integer, so every comparison is exact: no
tolerance applies.  The kernels themselves are held against the plain
versions on the card (``tests/test_torch_kernels_cuda.py``, ``cuda``)."""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plonky2_tpu.fields import goldilocks as jgl
from plonky2_tpu.fields import goldilocks_ext as jqe
from plonky2_tpu.gates import gates as JG
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.fields import goldilocks_ext as qe
from plonky2_tpu_torch.gates import gates as G
from plonky2_tpu_torch.kernels import build, launches
from plonky2_tpu_torch.kernels import goldilocks_mul as km
from plonky2_tpu_torch.proof.spec import load_circuit_spec

torch.set_num_threads(1)
P = gl.P
EDGE = np.array([0, 1, P - 1, (1 << 32) - 1, 1 << 32, P - (1 << 32)],
                dtype=np.uint64)
B = 3
# The test vector's weights (tests/test_torch_gates.py, from plonky2's gate
# tests).
TEST_WEIGHTS = [17293822565076172801, 18374686475376656385,
                18446744069413535745, 281474976645120, 17592186044416,
                18446744069414584577, 18446744000695107601,
                18446744065119617025, 1152921504338411520, 72057594037927936,
                18446744069415632897, 18446462594437939201,
                18446726477228539905, 18446744069414584065, 68719476720,
                4294967296]


def rand_gl(rng, shape):
    """uint64 values of ``shape``; the first elements take the edge values."""
    v = np.array(rng.integers(0, P, size=shape, dtype=np.uint64))
    f = v.reshape(-1)
    f[:min(f.size, EDGE.size)] = EDGE[:f.size]
    return v


def tsplit(vals):
    return tuple(t.reshape(np.shape(vals)) for t in gl.split_u64(vals))


def jsplit(vals):
    vals = np.asarray(vals, dtype=np.uint64)
    return (jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((vals >> np.uint64(32)).astype(np.uint32)))


def junpack(a):
    return (np.asarray(a[0], np.uint64)
            | (np.asarray(a[1], np.uint64) << np.uint64(32)))


# (a shape, b shape) of the call sites at B=3: lane by lane; a column
# against a row of columns (B, 1) x (B, n); a constant table (n,) against
# (B, n) (goldilocks_ext.mul_const_arr); (B, k, 1) against (B, k, n); a
# scalar against (B, n); and the 6 x 6 edge pairs, (6, 1) against (1, 6).
BCAST = [((B,), (B,)), ((B, 1), (B, 5)), ((5,), (B, 5)),
         ((B, 4, 1), (B, 4, 5)), ((), (B, 5)), ((B, 5), (B, 1)),
         ((6, 1), (1, 6))]
EDGE_GRID = BCAST[-1]
CONSTS = [0, 1, 7, gl.DTH_ROOT, P - 1, 1 << 32, (1 << 32) - 1,
          12345678901234567]


def _case(shapes, k):
    """QE operands a, b and addend c (uint64 coefficient pairs) of case k;
    the edge grid takes every pair of edge values in both coefficients."""
    if shapes == EDGE_GRID:
        a = (EDGE.reshape(6, 1), EDGE[::-1].reshape(6, 1))
        b = (EDGE.reshape(1, 6), EDGE[::-1].reshape(1, 6))
    else:
        rng = np.random.default_rng(k)
        a = (rand_gl(rng, shapes[0]), rand_gl(rng, shapes[0]))
        b = (rand_gl(rng, shapes[1]), rand_gl(rng, shapes[1]))
    lead = np.broadcast_shapes(*shapes)
    rng = np.random.default_rng(100 + k)
    return a, b, (rand_gl(rng, lead), rand_gl(rng, lead))


@pytest.fixture(scope="module")
def reference_products():
    """The JAX package's products of every case of BCAST, in one call per
    function: the operands broadcast in numpy and laid end to end (the JAX
    functions are elementwise, so this is the same function; the port's
    plain versions take the operands as the call sites give them).  Returns
    {case index: (gl.mul, qe.mul, qe.mul_add, {c: gl.mul_const})} as
    uint64 arrays of the case's lead shape."""
    cases = [_case(s, k) for k, s in enumerate(BCAST)]
    leads = [np.broadcast_shapes(*s) for s in BCAST]

    def flat(pick):
        return np.concatenate([np.broadcast_to(pick(c), lead).reshape(-1)
                               for c, lead in zip(cases, leads)])

    a, b, c = ([jsplit(flat(lambda x, i=i, j=j: x[i][j])) for j in range(2)]
               for i in range(3))
    outs = [junpack(jgl.mul(a[0], b[0])),
            tuple(map(junpack, jqe.mul(a, b))),
            tuple(map(junpack, jqe.mul_add(a, b, c))),
            {k: junpack(jgl.mul_const(a[0], k)) for k in CONSTS}]
    ends = np.cumsum([0] + [math.prod(lead) for lead in leads])

    def cut(v, k):
        return v[ends[k]:ends[k + 1]].reshape(leads[k])

    return {k: (cut(outs[0], k), tuple(cut(v, k) for v in outs[1]),
                tuple(cut(v, k) for v in outs[2]),
                {c: cut(v, k) for c, v in outs[3].items()})
            for k in range(len(BCAST))}


def _tq(v):
    return tuple(tsplit(x) for x in v)


def _eq(got, want):
    """A port GL or QE value equals uint64 arrays, shape included."""
    if isinstance(want, np.ndarray):
        got, want = (got,), (want,)
    return all(gl.join_u64(g).shape == w.shape
               and np.array_equal(gl.join_u64(g), w)
               for g, w in zip(got, want))


@pytest.mark.parametrize("k", range(len(BCAST)),
                         ids=[f"{a}x{b}" for a, b in BCAST])
def test_gl_mul_and_mul_const_plain_match_reference(reference_products, k):
    a, b, _ = _case(BCAST[k], k)
    want_mul, _, _, want_const = reference_products[k]
    assert _eq(gl.mul_plain(tsplit(a[0]), tsplit(b[0])), want_mul)
    lead = want_mul.shape
    full = tsplit(np.broadcast_to(a[0], lead))
    for c in CONSTS:
        assert _eq(gl.mul_const_plain(full, c), want_const[c])


@pytest.mark.parametrize("k", range(len(BCAST)),
                         ids=[f"{a}x{b}" for a, b in BCAST])
def test_qe_mul_and_mul_add_plain_match_reference(reference_products, k):
    a, b, c = (_tq(v) for v in _case(BCAST[k], k))
    _, want_mul, want_add, _ = reference_products[k]
    assert _eq(qe.mul_plain(a, b), want_mul)
    assert _eq(qe.mul_add_plain(a, b, c), want_add)


def test_qe_mul_plain_on_strided_views_matches_reference(reference_products):
    """``prod_axis``'s pattern: the even and odd columns of one array, here
    the interleaved operands of the (B, 4, 1) x (B, 4, 5) case."""
    k = BCAST.index(((B, 4, 1), (B, 4, 5)))
    a, b, _ = _case(BCAST[k], k)
    lead = (B, 4, 5)
    both = [np.stack([np.broadcast_to(x, lead), np.broadcast_to(y, lead)], -1)
            .reshape(lead[:-1] + (10,)) for x, y in zip(a, b)]
    t = _tq(both)
    ev, od = (qe.index(t, (Ellipsis, slice(j, None, 2))) for j in (0, 1))
    assert not ev[0][0].is_contiguous()
    assert _eq(qe.mul_plain(ev, od), reference_products[k][1])


# -- the interpolation gate's chunk scan -------------------------------------

def _step_fixture_weights():
    spec = load_circuit_spec("testdata/step/common_circuit_data.json")
    gate, = [g for g in spec.gates() if isinstance(g, G.CosetInterpolationGate)]
    assert (gate.subgroup_bits, gate.degree) == (4, 6)
    return gate.weights


@pytest.fixture(scope="module")
def gate_inputs():
    """Wires, constants and the public-input hash at B=3, and the JAX
    gate's output for each distinct list of weights, computed once (the
    JAX gate costs seconds a call on the CPU: op by op, jit disabled)."""
    rng = np.random.default_rng(7)
    n_wires = 50  # the gate reads wires 0..46
    inputs = ((rand_gl(rng, (B, 2)), rand_gl(rng, (B, 2))),
              (rand_gl(rng, (B, n_wires)), rand_gl(rng, (B, n_wires))),
              rand_gl(rng, (B, 4)))
    done = {}

    def reference(weights):
        key = tuple(weights)
        if key not in done:
            consts, wires, pih = inputs
            with jax.disable_jit():
                out = JG.CosetInterpolationGate(4, 6, weights).eval(
                    tuple(map(jsplit, consts)), tuple(map(jsplit, wires)),
                    jsplit(pih))
            done[key] = tuple(map(junpack, out))
        return done[key]

    return inputs, reference


@pytest.mark.parametrize("weights", ["step", "test_vector"])
def test_coset_interp_scan_plain_matches_reference_gate(gate_inputs, weights):
    w = _step_fixture_weights() if weights == "step" else TEST_WEIGHTS
    (consts, wires, pih), reference = gate_inputs
    gate = G.CosetInterpolationGate(4, 6, w)
    got = gate.eval(_tq(consts), _tq(wires), tsplit(pih))
    assert got[0][0].shape == (B, 2 + 4 * gate.num_intermediates + 2)
    assert _eq(got, reference(w))


@pytest.mark.parametrize("weights", ["step", "test_vector"])
def test_scan_kernels_order_matches_reference_gate(gate_inputs, weights,
                                                    monkeypatch):
    """The gate with its chunk steps in the scan kernel's order (segment
    prefix and suffix products, xor-shuffle sums, the masked tail:
    ``test_torch_coset_scan.segment_scan``) against the JAX gate, whose
    steps are a ``jax.lax.scan``."""
    from test_torch_coset_scan import segment_scan
    monkeypatch.setattr(G, "coset_interp_scan", segment_scan)
    w = _step_fixture_weights() if weights == "step" else TEST_WEIGHTS
    (consts, wires, pih), reference = gate_inputs
    got = G.CosetInterpolationGate(4, 6, w).eval(_tq(consts), _tq(wires),
                                                 tsplit(pih))
    assert _eq(got, reference(w))


def test_coset_interp_scan_dispatches_to_its_plain_version_on_the_cpu():
    gate = G.CosetInterpolationGate(4, 6, TEST_WEIGHTS)
    rng = np.random.default_rng(8)
    ni = gate.num_intermediates

    def ea(shape):
        return tuple(tuple(tsplit(rand_gl(rng, shape)) for _ in range(2))
                     for _ in range(2))

    args = (ea((B, ni)), ea((B, ni)), ea((B, gate.num_points)), ea((B, 1)),
            gate.schedule)
    launches.reset()
    got = G.coset_interp_scan(*args)
    want = G.coset_interp_scan_plain(*G.coset_interp_scan_operands(*args))
    leaves = torch.utils._pytree.tree_leaves
    assert all(torch.equal(g, w) for g, w in zip(leaves(got), leaves(want)))
    assert set(launches.read().values()) == {0}


# -- the wrappers' broadcast layout ------------------------------------------

def _view(shape, stride, offset=0):
    """A view whose elements are their own storage offsets."""
    n = offset + 1 + sum((s - 1) * st for s, st in zip(shape, stride))
    return torch.arange(max(n, 1)).as_strided(shape, stride, offset)


def _addressed(view, dims, strides):
    """The storage offsets the kernel reads, element by element of the
    row-major walk over ``dims``."""
    if not dims:
        return np.asarray([view.storage_offset()])
    idx = np.indices(dims).reshape(len(dims), -1)
    return view.storage_offset() + (np.asarray(strides)[:, None] * idx).sum(0)


# name: the planes' (shape, stride, storage offset), and the dims expected
LAYOUTS = {
    "column x row": ([((B, 1), (1, 1), 0), ((B, 5), (5, 1), 0)], (B, 5)),
    "table x rows": ([((5,), (1,), 0), ((B, 5), (5, 1), 0)], (B, 5)),
    "(B, k, 1) x (B, k, n)": ([((B, 4, 1), (4, 1, 1), 0),
                               ((B, 4, 5), (20, 5, 1), 0)], (B * 4, 5)),
    "even x odd columns": ([((B, 4), (8, 2), 0), ((B, 4), (8, 2), 1)],
                           (B * 4,)),
    "wire column": ([((B,), (80, ), 7), ((B,), (1,), 0)], (B,)),
    "scalar x rows": ([((), (), 0), ((B, 5), (5, 1), 0)], (B * 5,)),
    "all ones": ([((1, 1), (1, 1), 0), ((1,), (1,), 0)], ()),
    "transposed": ([((6, 5), (1, 6), 0), ((6, 5), (5, 1), 0)], (6, 5)),
    "5-d, mergeable": ([((2, 3, 4, 5, 6), (360, 120, 30, 6, 1), 0),
                        ((1, 3, 1, 5, 6), (90, 30, 30, 6, 1), 0)],
                       (2, 3, 4, 30)),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_broadcast_layout_addresses_the_broadcast_elements(name):
    planes, want_dims = LAYOUTS[name]
    views = [_view(*p) for p in planes]
    lead, dims, strides = km.broadcast_layout([v.shape for v in views],
                                              [v.stride() for v in views])
    assert lead == tuple(torch.broadcast_shapes(*(v.shape for v in views)))
    assert dims == want_dims and math.prod(dims) == math.prod(lead)
    for v, st in zip(views, strides):
        want = torch.broadcast_to(v, lead).reshape(-1).numpy()
        assert np.array_equal(_addressed(v, dims, st), want)


def test_broadcast_layout_of_an_empty_lead_shape():
    lead, dims, _ = km.broadcast_layout([(B, 0), (B, 1)], [(1, 1), (1, 1)])
    assert lead == (B, 0) and math.prod(dims) == 0


def test_descriptor_refuses_more_dims_than_the_kernel_takes():
    """Five axes that no two planes walk alike stay five."""
    a = torch.zeros((2, 1, 2, 1, 2), dtype=torch.int64)
    b = torch.zeros((1, 2, 1, 2, 1), dtype=torch.int64)
    with pytest.raises(ValueError):
        km._descriptor([a, b], "test")
    lead, n, words = km._descriptor([a, a], "test")
    assert (lead, n, list(words)[:3]) == ((2, 1, 2, 1, 2), 8, [8, 1, 8])


# -- the contract on the CPU -------------------------------------------------

def test_public_products_launch_nothing_on_the_cpu():
    rng = np.random.default_rng(9)
    a, b, c = ((tsplit(rand_gl(rng, (B, 4))), tsplit(rand_gl(rng, (B, 4))))
               for _ in range(3))
    launches.reset()
    pairs = [(gl.mul(a[0], b[0]), gl.mul_plain(a[0], b[0])),
             (gl.mul_const(a[0], 7), gl.mul_const_plain(a[0], 7)),
             (qe.mul(a, b), qe.mul_plain(a, b)),
             (qe.mul_add(a, b, c), qe.mul_add_plain(a, b, c))]
    leaves = torch.utils._pytree.tree_leaves
    for got, want in pairs:
        assert all(torch.equal(g, w) for g, w in zip(leaves(got), leaves(want)))
    assert set(launches.read().values()) == {0}


def _zeros_qe(shape, d):
    return qe.zeros(shape, d)


def _zeros_ea(shape, d):
    return (qe.zeros(shape, d), qe.zeros(shape, d))


def _scan_args(d):
    gate = G.CosetInterpolationGate(4, 6, TEST_WEIGHTS)
    return (_zeros_ea((B, 2), d), _zeros_ea((B, 2), d),
            _zeros_ea((B, 16), d), _zeros_ea((B, 1), d), gate.schedule)


@pytest.mark.parametrize("wrapper", ["gl_mul", "gl_mul_const", "qe_mul",
                                     "qe_mul_add", "coset_interp_scan"])
def test_kernel_wrappers_raise_for_a_cpu_tensor(wrapper):
    d = "cpu"
    calls = {
        "gl_mul": lambda: km.gl_mul(gl.zeros((B,), d), gl.zeros((B,), d)),
        "gl_mul_const": lambda: km.gl_mul_const(gl.zeros((B,), d), 7),
        "qe_mul": lambda: km.qe_mul(_zeros_qe((B,), d), _zeros_qe((B,), d)),
        "qe_mul_add": lambda: km.qe_mul(_zeros_qe((B,), d), _zeros_qe((B,), d),
                                        _zeros_qe((B,), d)),
        "coset_interp_scan": lambda: km.coset_interp_scan(*_scan_args(d)),
    }
    with pytest.raises(build.KernelError):
        calls[wrapper]()


@pytest.mark.parametrize("fn", ["mul", "mul_const", "qe_mul", "qe_mul_add",
                                "coset_interp_scan"])
def test_public_functions_have_no_fallback_off_the_cpu(fn):
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel's wrapper, which launches or raises (here a meta tensor,
    which has no kernel)."""
    d = "meta"
    calls = {
        "mul": lambda: gl.mul(gl.zeros((B,), d), gl.zeros((B,), d)),
        "mul_const": lambda: gl.mul_const(gl.zeros((B,), d), gl.DTH_ROOT),
        "qe_mul": lambda: qe.mul(_zeros_qe((B,), d), _zeros_qe((B,), d)),
        "qe_mul_add": lambda: qe.mul_add(_zeros_qe((B,), d), _zeros_qe((B,), d),
                                         _zeros_qe((B,), d)),
        "coset_interp_scan": lambda: G.coset_interp_scan(*_scan_args(d)),
    }
    with pytest.raises(build.KernelError):
        calls[fn]()


def test_mul_const_by_0_and_1_launches_nothing_on_any_device():
    a = gl.zeros((B,), "meta")
    assert gl.mul_const(a, 1) is a
    z = gl.mul_const(a, 0)
    assert z[0].shape == (B,) and z[0].device.type == "meta"
