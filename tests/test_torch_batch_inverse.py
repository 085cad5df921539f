"""The QE inverse kernel's batch-inversion order (``csrc/goldilocks_ext.cu``
``qe_inv_kernel``) and FRI's bit-selected product by a constant
(``fields/goldilocks.mul_const_bits``), on the CPU.

- a plain-torch mirror of the kernel's order (each element's norm, 1 in
  place of 0; a lane's running product over its K elements; the warp's
  inclusive and exclusive scans over 32 lanes both ways; one inversion of
  the warp's total; the walk back; the scaling) against
  ``plonky2_tpu.fields.goldilocks_ext.inv`` (JAX on the CPU, called once on
  every case laid end to end) and the port's ``inv_plain``, for K = 1, 2, 4,
  8, at 1 to 7168 elements with 0 at lane 0, lane 31, the last element and
  a whole warp, and the edge values 0, 1, p-1, 2^32-1, 2^32, p-2^32 in
  either coordinate;
- ``mul_const_bits_plain`` against Python-int ``pow`` and against the JAX
  package's loops (``plonky2_tpu/fri/verify.py`` subgroup_x and
  cosetStart: a product by a constant and a select a bit) for the step
  fixture's lde_bits and for cosetStart at offsets 0 and 4 with 4 bits;
- the wrappers' contract: ``inv_per_thread``'s rule, the arguments they
  refuse, and no fallback off the CPU.

The arithmetic is modular and integer, so every comparison is exact: no
tolerance applies.  The kernels themselves are held against the plain
versions on the card (``tests/test_torch_kernels_cuda.py``, ``cuda``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_tpu.fields import goldilocks as jgl
from plonky2_tpu.fields import goldilocks_ext as jqe
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.fields import goldilocks_ext as qe
from plonky2_tpu_torch.kernels import build
from plonky2_tpu_torch.kernels import goldilocks_ext as kq
from plonky2_tpu_torch.kernels import goldilocks_mul as km
from plonky2_tpu_torch.proof.fixtures import load_fixture

torch.set_num_threads(1)
P = gl.P
EDGE = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, P - (1 << 32)]
COUNTS = [1, 31, 32, 33, 255, 257, 7168]
PER_THREAD = [1, 2, 4, 8]


def zeros_at(n):
    """0 at the first element, lane 31 of the first warp, the last, and from
    512 elements on all of [256, 512): a whole warp at every K."""
    zeros = {0, min(31, n - 1), n - 1}
    if n >= 512:
        zeros.update(range(256, 512))
    return sorted(zeros)


def case_values(n, seed):
    """(c0, c1) uint64 arrays of n elements: the edge pairs (but (0, 0))
    first, then random values, with 0 at ``zeros_at(n)``."""
    rng = np.random.default_rng(seed)
    c = [np.array(rng.integers(0, P, size=n, dtype=np.uint64))
         for _ in range(2)]
    pairs = [(a, b) for a in EDGE for b in EDGE if a or b][:n]
    for i, (a, b) in enumerate(pairs):
        c[0][i], c[1][i] = a, b
    for z in zeros_at(n):
        c[0][z] = c[1][z] = 0
    return c


def tq(v):
    return tuple(gl.split_u64(c) for c in v)


def tvals(a):
    return [gl.join_u64(c) for c in a]


def jq(v):
    return tuple((jnp.asarray((c & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
                  jnp.asarray((c >> np.uint64(32)).astype(np.uint32)))
                 for c in v)


def jvals(a):
    return [np.asarray(c[0], np.uint64)
            | (np.asarray(c[1], np.uint64) << np.uint64(32)) for c in a]


def _shift(x, d):
    """Each lane's value from lane - d (d > 0) or lane + |d| (d < 0), 1
    where that lane is outside the warp: __shfl_up_sync / __shfl_down_sync
    with the kernel's multiplication by 1 outside."""
    one = gl.ones_like(x)
    if d > 0:
        return tuple(torch.cat([o[:, :d], t[:, :-d]], dim=1)
                     for o, t in zip(one, x))
    return tuple(torch.cat([t[:, -d:], o[:, :-d]], dim=1)
                 for o, t in zip(one, x))


def batch_inverse_mirror(a, k):
    """The kernel's order on QE (n,): lane l of warp w holds the elements
    32 k w + 32 j + l, j < k."""
    n = a[0][0].shape[0]
    warps = -(-n // (32 * k))
    pad = warps * 32 * k - n

    def lay(t):  # (n,) -> (warps, k, 32), 0 past the end
        return torch.cat([t, t.new_zeros(pad)]).reshape(warps, k, 32)

    a0 = tuple(lay(t) for t in a[0])
    a1 = tuple(lay(t) for t in a[1])
    c1 = gl.sub(gl.zeros_like(a1), a1)
    norm = gl.add(gl.mul_plain(a0, a0),
                  gl.mul_const_plain(gl.mul_plain(a1, c1), gl.W))
    norm = gl.select(gl.is_zero(norm), gl.ones_like(norm), norm)
    step = [gl.index(norm, (slice(None), j)) for j in range(k)]
    q = [step[0]]
    for j in range(1, k):
        q.append(gl.mul_plain(q[-1], step[j]))
    inc = suf = q[-1]  # (warps, 32)
    for d in (1, 2, 4, 8, 16):
        inc = gl.mul_plain(inc, _shift(inc, d))
        suf = gl.mul_plain(suf, _shift(suf, -d))
    total = gl.index(inc, (slice(None), slice(31, 32)))
    y = gl.mul_plain(gl.mul_plain(gl.inv_plain(total), _shift(inc, 1)),
                     _shift(suf, -1))
    out = [None] * k
    for j in reversed(range(k)):
        ninv = gl.mul_plain(y, q[j - 1]) if j else y
        if j:
            y = gl.mul_plain(y, step[j])
        out[j] = (gl.mul_plain(gl.index(a0, (slice(None), j)), ninv),
                  gl.mul_plain(gl.index(c1, (slice(None), j)), ninv))
    return tuple(
        tuple(torch.stack([o[c][h] for o in out], dim=1).reshape(-1)[:n]
              for h in range(2))
        for c in range(2))


@pytest.fixture(scope="module")
def reference_inverses():
    """{n: (input, JAX inv)}: one JAX call on every case laid end to end."""
    cases = {n: case_values(n, seed=n) for n in COUNTS}
    joined = [np.concatenate([v[c] for v in cases.values()]) for c in range(2)]
    want = jvals(jqe.inv(jq(joined)))
    out, at = {}, 0
    for n, v in cases.items():
        out[n] = (v, [w[at:at + n] for w in want])
        at += n
    return out


@pytest.mark.parametrize("k", PER_THREAD)
@pytest.mark.parametrize("n", COUNTS)
def test_batch_inverse_order_matches_jax(reference_inverses, n, k):
    vals, want = reference_inverses[n]
    got = tvals(batch_inverse_mirror(tq(vals), k))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert all(not g[zeros_at(n)].any() for g in got)


@pytest.mark.parametrize("n", COUNTS)
def test_inv_plain_matches_jax(reference_inverses, n):
    vals, want = reference_inverses[n]
    got = tvals(qe.inv_plain(tq(vals)))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_a_whole_warp_of_zeros_gives_zeros():
    """A warp whose every norm is 0 inverts 1 and gives 0 everywhere."""
    a = tq([np.zeros(64, np.uint64), np.zeros(64, np.uint64)])
    for k in (1, 2):
        got = tvals(batch_inverse_mirror(a, k))
        assert not any(g.any() for g in got)


# -- FRI's bit-selected products by a constant ------------------------------

def _bitrev(v, n):
    return int(f"{v:0{n}b}"[::-1], 2)


@pytest.fixture(scope="module")
def step_spec():
    return load_fixture("testdata/step")[0]


def _index(shape, bits, seed):
    rng = np.random.default_rng(seed)
    v = np.array(rng.integers(0, 1 << bits, size=shape, dtype=np.uint64))
    v.reshape(-1)[:2] = [0, (1 << bits) - 1]
    return v


def _jax_subgroup_x(idx, lde_bits):
    """plonky2_tpu/fri/verify.py's subgroup_x loop on the JAX package."""
    bits = jgl.to_bits(jq([idx])[0], 64)[:lde_bits]
    prod = jgl.ones(idx.shape)
    pw = jgl.primitive_root_of_unity(lde_bits)
    for i in reversed(range(lde_bits)):
        prod = jgl.select(bits[i].astype(bool), jgl.mul_const(prod, pw), prod)
        pw = (pw * pw) % P
    return jvals([jgl.mul_const(prod, jgl.MULTIPLICATIVE_GROUP_GENERATOR)])[0]


def _jax_coset_start(x, idx, off, arity_bits):
    """plonky2_tpu/fri/verify.py's cosetStart loop, within_bits the bits
    off .. off + arity_bits - 1 of idx."""
    g = jgl.primitive_root_of_unity(arity_bits)
    pw = pow(g, (1 << arity_bits) - 1, P)
    within = jgl.to_bits(jq([idx])[0], 64)[off:off + arity_bits]
    start = jgl.ones(idx.shape)
    for i in reversed(range(arity_bits)):
        start = jgl.select(within[i].astype(bool), jgl.mul_const(start, pw),
                           start)
        pw = (pw * pw) % P
    return jvals([jgl.mul(start, jq([x])[0])])[0]


def test_subgroup_x_matches_pow_and_the_jax_loop(step_spec):
    lde = step_spec.lde_bits
    idx = _index((3, step_spec.num_query_rounds), lde, seed=1)
    root = gl.primitive_root_of_unity(lde)
    got = gl.join_u64(gl.mul_const_bits_plain(
        None, gl.MULTIPLICATIVE_GROUP_GENERATOR, gl.split_u64(idx), 0,
        gl.bitrev_powers(root, lde)))
    want = [gl.MULTIPLICATIVE_GROUP_GENERATOR * pow(root, _bitrev(int(v), lde),
                                                    P) % P
            for v in idx.reshape(-1)]
    assert got.reshape(-1).tolist() == want
    assert np.array_equal(got, _jax_subgroup_x(idx, lde))


@pytest.mark.parametrize("off", [0, 4])
def test_coset_start_matches_pow_and_the_jax_loop(step_spec, off):
    arity_bits = 4
    idx = _index((3, step_spec.num_query_rounds), step_spec.lde_bits, seed=2)
    x = np.random.default_rng(3).integers(0, P, size=idx.shape,
                                          dtype=np.uint64)
    g_inv = pow(gl.primitive_root_of_unity(arity_bits),
                (1 << arity_bits) - 1, P)
    got = gl.join_u64(gl.mul_const_bits_plain(
        gl.split_u64(x), 1, gl.split_u64(idx), off,
        gl.bitrev_powers(g_inv, arity_bits)))
    want = [int(xv) * pow(g_inv, _bitrev((int(v) >> off) & 15, arity_bits),
                          P) % P
            for xv, v in zip(x.reshape(-1), idx.reshape(-1))]
    assert got.reshape(-1).tolist() == want
    assert np.array_equal(got, _jax_coset_start(x, idx, off, arity_bits))


def test_mul_const_bits_takes_high_bits_and_broadcasts():
    """Bits 40 to 63 of 64-bit indices, a (3, 1) against the index (3, 5)."""
    rng = np.random.default_rng(4)
    idx = rng.integers(0, P, size=(3, 5), dtype=np.uint64)
    idx[0, 0] = P - 1
    a = rng.integers(0, P, size=(3, 1), dtype=np.uint64)
    table = [int(t) for t in rng.integers(0, P, size=24, dtype=np.uint64)]
    got = gl.join_u64(gl.mul_const_bits_plain(
        gl.split_u64(a), 5, gl.split_u64(idx), 40, table))
    want = np.empty_like(idx)
    for (r, col), v in np.ndenumerate(idx):
        acc = int(a[r, 0]) * 5
        for i, t in enumerate(table):
            if (int(v) >> (40 + i)) & 1:
                acc = acc * t % P
        want[r, col] = acc % P
    assert np.array_equal(got, want)


def test_mul_const_bits_dispatches_to_its_plain_version_on_the_cpu():
    idx = gl.split_u64(_index((4, 7), 16, seed=5))
    before = km.gl_mul_const.launches
    got = gl.mul_const_bits(None, 7, idx, 0, gl.bitrev_powers(3, 16))
    want = gl.mul_const_bits_plain(None, 7, idx, 0, gl.bitrev_powers(3, 16))
    assert km.gl_mul_const.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# -- the wrappers' contract --------------------------------------------------

def test_inv_per_thread_rule():
    assert [kq.inv_per_thread(n) for n in (256, 256 * 28, 256 * 28 * 16)] \
        == [1, 1, 4]
    for n in (1, 255, 7168, 32768, 32769, 65537, 131073, 10 ** 6):
        k = kq.inv_per_thread(n)
        assert k in kq.INV_PER_THREAD
        assert -(-n // k) <= kq.INV_THREAD_BUDGET or k == 8
        assert k == 1 or -(-n // (k // 2)) > kq.INV_THREAD_BUDGET


def test_inv_refuses_another_per_thread_count():
    with pytest.raises(ValueError):
        kq.inv(qe.zeros((4,), "cpu"), per_thread=3)


@pytest.mark.parametrize("args", [
    (None, 7, None, 0, ()),        # neither a nor an index
    ("a", 7, None, 0, (3,)),       # a table without an index
    (None, 7, "idx", 0, ()),       # an index without a table
    (None, 7, "idx", 60, (3,) * 5),  # past bit 63
    (None, 7, "idx", -1, (3,)),
    (None, 7, "idx", 0, (3,) * 65)])
def test_mul_const_wrapper_refuses_bad_bit_arguments(args):
    a, c, idx, off, table = args
    v = gl.zeros((4,), "cpu")
    with pytest.raises(ValueError):
        km.gl_mul_const(v if a else None, c, v if idx else None, off,
                        list(table))


def test_mul_const_bits_wrapper_raises_for_a_cpu_tensor():
    with pytest.raises(build.KernelError):
        km.gl_mul_const(None, 7, gl.zeros((4,), "cpu"), 0, [3, 5])


def test_mul_const_bits_has_no_fallback_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel's wrapper, which launches or raises (here a meta tensor,
    which has no kernel)."""
    idx = gl.zeros((4,), "meta")
    with pytest.raises(build.KernelError):
        gl.mul_const_bits(None, 7, idx, 0, [3, 5])
    with pytest.raises(build.KernelError):
        gl.mul_const_bits(gl.zeros((4,), "meta"), 1, idx, 4, [3, 5])
