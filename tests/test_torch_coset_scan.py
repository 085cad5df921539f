"""The evaluation order of the interpolation gate's scan kernel
(``coset_interp_scan_kernel``, ``csrc/goldilocks_mul.cu``) and its
wrapper's contract (``kernels/goldilocks_mul.coset_interp_scan``).

The kernel runs a chunk's steps side by side: a segment of S = 2^k >= deg
steps a (lane, chunk), step j forming t_j = pt - x_j and u_j = w_j v_j (t =
1, u = 0 where the step is inactive or j >= deg), the segment's exclusive
prefix and suffix products of the t's by shuffles, the terms u_j prefix_j
suffix_j summed over xor partners, and step 0 writing ev0 P + pr0 sum and
pr0 P, P the product of every t.  A step is a group of up to 4 threads
that split each EA product; the products and their order are the same.

- ``segment_scan``, a plain-torch mirror of that order, against the port's
  ``coset_interp_scan_plain``: both fixtures' gate (subgroup_bits 4, degree
  6), a gate of degree 5 (not a power of two), a gate of one chunk (degree
  8, and degree 32: a segment of a whole warp), a synthetic schedule of
  degree 1 and one of degree 3 with a mask that is not a prefix; lanes
  holding 0, 1, p-1, 2^32-1, 2^32 and p-2^32 in every coordinate, and a
  point equal to a domain point (a zero t).  The JAX gate, whose chunk
  steps are a ``jax.lax.scan``, costs about ten seconds a call on the CPU:
  ``tests/test_torch_field_kernels.py`` holds the gate with its scan in
  this order against it, on the JAX run it already makes;
- the same mirror against ``coset_interp_scan_plain`` at 1, 31, 33, 255,
  256 and 257 lanes on both fixtures' gate, and ``gates.coset_interp_scan``
  dispatching to the plain version for a CPU tensor;
- the wrapper's contract: the host schedule's cells (``scan_cells``), the
  operands' shapes and strides (``scan_strides``), and ``KernelError`` for
  a tensor that is not on a GPU (its dtype check runs on the card,
  ``tests/test_torch_kernels_cuda.py``).

The arithmetic is modular and integer, so every comparison is exact: no
tolerance applies.  The kernel itself is held against the plain version on
the card (``tests/test_torch_kernels_cuda.py``, ``cuda``)."""
import functools

import numpy as np
import pytest
import torch

from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.fields import goldilocks_ext as qe
from plonky2_tpu_torch.gates import gates as G
from plonky2_tpu_torch.kernels import build, launches
from plonky2_tpu_torch.kernels import goldilocks_mul as km
from plonky2_tpu_torch.proof.spec import load_circuit_spec

torch.set_num_threads(1)
P = gl.P
EDGE = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, P - (1 << 32)]
LANE_COUNTS = [1, 31, 33, 255, 256, 257]


# -- inputs -------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def fixture_gate(fixture):
    spec = load_circuit_spec(f"testdata/{fixture}/common_circuit_data.json")
    gate, = [g for g in spec.gates() if isinstance(g, G.CosetInterpolationGate)]
    return gate


def synthetic_schedule(deg, chunks, active, seed):
    """A schedule of random domain points and weights (GL (lo, hi) numpy
    pairs), value columns deg c + j, and ``active`` (deg, chunks)."""
    rng = np.random.default_rng(seed)

    def gl_pair():
        v = rng.integers(0, P, size=(deg, chunks), dtype=np.uint64)
        return gl.const_array(v.tolist())

    vidx = (np.arange(chunks)[None, :] * deg + np.arange(deg)[:, None])
    return gl_pair(), gl_pair(), vidx.astype(np.int64), np.asarray(active)


def schedule_of(case):
    """(schedule, number of value columns) of a named case."""
    if case in ("step", "decode_block"):
        gate = fixture_gate(case)
        return gate.schedule, gate.num_points
    if case.startswith("gate"):  # gate-<subgroup bits>-<degree>
        bits, deg = map(int, case.split("-")[1:])
        gate = G.CosetInterpolationGate(bits, deg, list(range(1, 1 + (1 << bits))))
        return gate.schedule, gate.num_points
    if case == "deg1":
        return synthetic_schedule(1, 5, np.ones((1, 5), bool), 1), 5
    assert case == "deg3-mask"
    mask = np.asarray([[1, 0, 1, 1], [0, 0, 1, 0], [1, 1, 1, 0]], bool)
    return synthetic_schedule(3, 4, mask, 3), 12


def host_u64(pair):
    """A (lo, hi) numpy pair of the schedule -> uint64."""
    lo, hi = (np.asarray(h).astype(np.uint64) for h in pair)
    return lo | (hi << np.uint64(32))


def edge_ea(rng, shape):
    """Random EA values as four uint64 arrays (a.c0, a.c1, b.c0, b.c1);
    lane i < 6 takes EDGE[(i + k) % 6] in coordinate k everywhere."""
    coords = [np.array(rng.integers(0, P, size=shape, dtype=np.uint64))
              for _ in range(4)]
    for k, c in enumerate(coords):
        for i in range(min(6, shape[0])):
            c[i] = EDGE[(i + k) % 6]
    return coords


def scan_inputs(case, lanes, seed):
    """(inter_eval, inter_prod, values, pt) as uint64 coordinates, and the
    schedule.  From lane 6 on, a few lanes take a point equal to a domain
    point of the schedule (x_j, 0, 0, 0): that step's t is 0."""
    schedule, n = schedule_of(case)
    deg, chunks = schedule[3].shape
    rng = np.random.default_rng(seed)
    inter_eval = edge_ea(rng, (lanes, chunks - 1))
    inter_prod = edge_ea(rng, (lanes, chunks - 1))
    values = edge_ea(rng, (lanes, n))
    pt = edge_ea(rng, (lanes, 1))
    xs = host_u64(schedule[0])
    cells = sorted(zip(*np.nonzero(schedule[3])), key=lambda jc: jc[::-1])
    for lane in range(6, min(lanes, 6 + 3)):
        j, c = cells[[0, len(cells) // 2, -1][lane - 6]]
        pt[0][lane, 0] = xs[j, c]
        for k in (1, 2, 3):
            pt[k][lane, 0] = 0
    return (inter_eval, inter_prod, values, pt), schedule


def torch_ea(coords):
    return tuple(tuple(tuple(t.reshape(c.shape) for t in gl.split_u64(c))
                       for c in coords[i:i + 2]) for i in (0, 2))


def torch_coords(ea):
    return [gl.join_u64(c) for half in ea for c in half]


# -- the mirror of the kernel's order ----------------------------------------

def _ea_select(mask, a, b):
    return (qe.select(mask, a[0], b[0]), qe.select(mask, a[1], b[1]))


def _ea_index(a, idx):
    return (qe.index(a[0], idx), qe.index(a[1], idx))


def _ea_const(value, shape):
    one = value == 1
    return ((qe.ones(shape) if one else qe.zeros(shape)), qe.zeros(shape))


def _shift(a, d, fill):
    """Along the segment axis: a[..., j - d] (d > 0) or a[..., j - d] (d <
    0, from above), ``fill`` where j - d leaves the segment, as
    ``__shfl_up_sync`` / ``__shfl_down_sync`` followed by the kernel's
    select."""
    S = a[0][0][0].shape[-1]
    j = torch.arange(S)
    src = (j - d).clamp(0, S - 1)
    inside = (j - d >= 0) & (j - d < S)
    return _ea_select(inside, _ea_index(a, (Ellipsis, src)),
                      _ea_const(fill, a[0][0][0].shape))


def segment_scan(inter_eval, inter_prod, values, pt, schedule):
    """The scan in the kernel's order, every segment at once: (ev, pr) EA
    (B, C) from the wrapper's arguments."""
    x, w, col, log_seg = km.scan_cells(schedule)
    S = 1 << log_seg
    C = len(col) // S
    B = values[0][0][0].shape[0]
    shape = (B, C, S)
    col = torch.as_tensor(col.astype(np.int64)).reshape(C, S)
    live = col >= 0
    x = tuple(t.reshape(C, S) for t in gl.split_u64(x))
    w = tuple(t.reshape(C, S) for t in gl.split_u64(w))

    v = _ea_index(values, (Ellipsis, col.clamp(min=0)))     # (B, C, S)
    pt = _ea_index(pt, (Ellipsis, slice(None), None))        # (B, 1 | C, 1)
    pt = tuple(tuple(tuple(h.expand(shape) for h in c) for c in half)
               for half in pt)
    t = ((gl.sub(pt[0][0], x), pt[0][1]), pt[1])
    t = _ea_select(live, t, _ea_const(1, shape))
    u = tuple(tuple(gl.mul(c, w) for c in half) for half in v)
    u = _ea_select(live, u, _ea_const(0, shape))

    pre, suf = t, t
    d = 1
    while d < S:
        pre = qe.ea_mul(_shift(pre, d, 1), pre)
        suf = qe.ea_mul(suf, _shift(suf, -d, 1))
        d *= 2
    before, after = _shift(pre, 1, 1), _shift(suf, -1, 1)
    total = qe.ea_mul(qe.ea_mul(u, before), after)
    d = 1
    while d < S:
        total = qe.ea_add(total, _ea_index(
            total, (Ellipsis, torch.arange(S) ^ d)))
        d *= 2

    first = (Ellipsis, 0)
    prod, total = _ea_index(suf, first), _ea_index(total, first)  # (B, C)
    ev0 = tuple(qe.concat([z, c]) for z, c in
                zip(_ea_const(0, (B, 1)), inter_eval))
    pr0 = tuple(qe.concat([o, c]) for o, c in
                zip(_ea_const(1, (B, 1)), inter_prod))
    return (qe.ea_add(qe.ea_mul(ev0, prod), qe.ea_mul(pr0, total)),
            qe.ea_mul(pr0, prod))


def plain(args, schedule):
    return G.coset_interp_scan_plain(
        *G.coset_interp_scan_operands(*args, schedule))


def as_coords(out):
    return [torch_coords(x) for x in out]


# -- the mirror against the plain version ------------------------------------

ORDER_CASES = ["step", "decode_block", "gate-4-5", "gate-3-8", "gate-5-32",
               "deg1", "deg3-mask"]
ORDER_LANES = 12


def _same(got, want):
    return all(len(g) == len(w) and all(
        a.shape == b.shape and np.array_equal(a, b) for a, b in zip(g, w))
        for g, w in zip(got, want))


@pytest.mark.parametrize("case", ORDER_CASES)
def test_segment_order_matches_the_plain_scan(case):
    coords, schedule = scan_inputs(case, ORDER_LANES,
                                   seed=ORDER_CASES.index(case))
    args = tuple(torch_ea(c) for c in coords)
    got = as_coords(segment_scan(*args, schedule))
    assert got[0][0].shape == (ORDER_LANES, schedule[3].shape[1])
    assert _same(got, as_coords(plain(args, schedule)))


@pytest.mark.parametrize("lanes", LANE_COUNTS)
def test_segment_order_matches_the_plain_scan_at_lane_counts(lanes):
    for fixture in ("step", "decode_block"):
        coords, schedule = scan_inputs(fixture, lanes, seed=lanes)
        args = tuple(torch_ea(c) for c in coords)
        got = as_coords(segment_scan(*args, schedule))
        assert got[0][0].shape == (lanes, 3)
        assert _same(got, as_coords(plain(args, schedule))), fixture


def test_a_zero_t_zeroes_the_chunks_product():
    coords, schedule = scan_inputs("step", 9, seed=5)
    ev, pr = segment_scan(*(torch_ea(c) for c in coords), schedule)
    pr = torch_coords(pr)
    for lane, chunk in ((6, 0), (7, 1), (8, 2)):
        assert all(c[lane, chunk] == 0 for c in pr)


def test_scan_dispatches_to_the_plain_version_on_the_cpu():
    coords, schedule = scan_inputs("step", 5, seed=6)
    args = tuple(torch_ea(c) for c in coords)
    launches.reset()
    got = as_coords(G.coset_interp_scan(*args, schedule))
    assert _same(got, as_coords(plain(args, schedule)))
    assert set(launches.read().values()) == {0}


# -- the wrapper's contract --------------------------------------------------

def test_scan_cells_lay_out_the_fixture_schedule():
    gate = fixture_gate("step")
    x, w, col, log_seg = km.scan_cells(gate.schedule)
    assert log_seg == 3 and len(x) == len(w) == len(col) == 3 * 8
    assert x.dtype == w.dtype == np.uint64 and col.dtype == np.int32
    col = col.reshape(3, 8)
    assert col[0].tolist() == [0, 1, 2, 3, 4, 5, -1, -1]
    assert col[1].tolist() == [6, 7, 8, 9, 10, -1, -1, -1]
    assert col[2].tolist() == [11, 12, 13, 14, 15, -1, -1, -1]
    xs = host_u64(gate.schedule[0])
    domain = gl.two_adic_subgroup(4)
    assert x.reshape(3, 8)[1, :5].tolist() == [domain[i] for i in range(6, 11)]
    assert x.reshape(3, 8)[1, :5].tolist() == xs[:5, 1].tolist()
    assert (w.reshape(3, 8)[:, 6:] == 0).all()


@pytest.mark.parametrize("deg, log_seg", [(1, 0), (2, 1), (3, 2), (5, 3),
                                          (6, 3), (8, 3), (9, 4), (32, 5)])
def test_scan_segment_is_the_least_power_of_two_at_or_above_deg(deg, log_seg):
    schedule = synthetic_schedule(deg, 2, np.ones((deg, 2), bool), deg)
    assert km.scan_cells(schedule)[3] == log_seg


@pytest.mark.parametrize("deg, chunks", [(33, 1), (32, 5), (5, 17)])
def test_scan_cells_refuse_what_the_kernel_cannot_hold(deg, chunks):
    schedule = synthetic_schedule(deg, chunks, np.ones((deg, chunks), bool), 0)
    with pytest.raises(ValueError):
        km.scan_cells(schedule)


def test_scan_strides_read_the_gates_wire_columns_in_place():
    gate = fixture_gate("step")
    wires = qe.zeros((4, 135))
    cols = G._ea_cols
    inter_eval = cols(wires, 37, 2)
    inter_prod = cols(wires, 41, 2)
    values = cols(wires, 1, 16)
    pt = tuple(qe.index(c, (Ellipsis, None)) for c in cols(wires, 45, 1))
    pt = tuple(qe.index(c, (Ellipsis, 0)) for c in pt)
    lanes, strides = km.scan_strides(inter_eval, inter_prod, values, pt, 3)
    assert lanes == 4 and len(strides) == 32
    assert strides[:16] == [(135, 2)] * 16  # wire columns, two apart
    assert strides[16:24] == [(135, 0)] * 8  # one column: it broadcasts
    assert strides[24:] == [(135, 2)] * 8
    assert gate.num_points == 16


@pytest.mark.parametrize("bad", ["intermediates", "point", "lanes", "rank"])
def test_scan_strides_refuse_other_shapes(bad):
    def ea(shape):
        return (qe.zeros(shape), qe.zeros(shape))

    args = {"intermediates": ea((4, 2)), "point": ea((4, 1)),
            "values": ea((4, 16))}
    if bad == "intermediates":
        args["intermediates"] = ea((4, 3))
    elif bad == "point":
        args["point"] = ea((4, 2))
    elif bad == "lanes":
        args["point"] = ea((5, 1))
    else:
        args["values"] = ea((4, 2, 8))
    with pytest.raises(ValueError):
        km.scan_strides(args["intermediates"], args["intermediates"],
                        args["values"], args["point"], 3)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_scan_wrapper_raises_off_a_gpu(device):
    gate = fixture_gate("step")

    def ea(shape):
        return (qe.zeros(shape, device), qe.zeros(shape, device))

    args = (ea((4, 2)), ea((4, 2)), ea((4, 16)), ea((4, 1)), gate.schedule)
    with pytest.raises(build.KernelError):
        km.coset_interp_scan(*args)
    if device == "meta":  # only a CPU tensor takes the plain version
        with pytest.raises(build.KernelError):
            G.coset_interp_scan(*args)
