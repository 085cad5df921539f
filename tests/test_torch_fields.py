"""Field parity: the port's Goldilocks, quadratic-extension and BN254 ops
against the JAX package's ops on the same random inputs (always including
0, 1 and p-1), plus the golden vectors of test_goldilocks.py and
test_bn254.py.  The arithmetic is modular and integer, so every comparison
is exact (np.array_equal on the integer limbs): no tolerance applies."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plonky2_tpu.fields import bn254 as jbn
from plonky2_tpu.fields import goldilocks as jgl
from plonky2_tpu.fields import goldilocks_ext as jqe
from plonky2_tpu_torch.fields import bn254
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.fields import goldilocks_ext as qe

torch.set_num_threads(1)
P = gl.P
EDGE = np.array([0, 1, P - 1, 2, P - 2, (1 << 32) - 1, 1 << 32,
                 (1 << 32) + 1, P - (1 << 32), gl.DTH_ROOT], dtype=np.uint64)


def rand_gl(rng, n):
    return np.concatenate([EDGE, rng.integers(0, P, size=n, dtype=np.uint64)])


def jpack(vals):
    vals = np.asarray(vals, dtype=np.uint64)
    return (jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((vals >> np.uint64(32)).astype(np.uint32)))


def junpack(a):
    return (np.asarray(a[0], np.uint64)
            | (np.asarray(a[1], np.uint64) << np.uint64(32)))


def tpack(vals):
    return gl.split_u64(vals)


def tunpack(a):
    return gl.join_u64(a)


BINARY = ["add", "sub", "mul", "mul_add"]


@pytest.mark.parametrize("op", BINARY + ["neg", "inv", "pow", "mul_const"])
def test_goldilocks_ops_match_reference(op):
    rng = np.random.default_rng(101)
    x = rand_gl(rng, 300)
    y = np.flip(rand_gl(rng, 300))
    z = np.roll(rand_gl(rng, 300), 5)
    if op == "mul_add":
        got = gl.mul_add(tpack(x), tpack(y), tpack(z))
        want = jgl.mul_add(jpack(x), jpack(y), jpack(z))
    elif op in BINARY:
        got = getattr(gl, op)(tpack(x), tpack(y))
        want = getattr(jgl, op)(jpack(x), jpack(y))
    elif op == "neg":
        got, want = gl.neg(tpack(x)), jgl.neg(jpack(x))
    elif op == "inv":
        got, want = gl.inv(tpack(x[:40])), jgl.inv(jpack(x[:40]))
    elif op == "pow":
        got = gl.pow_const(tpack(x), 12345)
        want = jgl.pow_const(jpack(x), 12345)
    else:
        for c in [0, 1, 7, gl.DTH_ROOT, P - 1, (1 << 48) + 12345]:
            assert np.array_equal(tunpack(gl.mul_const(tpack(x), c)),
                                  junpack(jgl.mul_const(jpack(x), c))), c
        return
    assert np.array_equal(tunpack(got), junpack(want))


def test_goldilocks_python_int_truth():
    """Against plain Python ints as well (test_goldilocks.py's ground truth)."""
    rng = np.random.default_rng(7)
    x, y = rand_gl(rng, 200), np.flip(rand_gl(rng, 200))
    X, Y = x.astype(object), y.astype(object)
    assert (tunpack(gl.add(tpack(x), tpack(y))) == (X + Y) % P).all()
    assert (tunpack(gl.sub(tpack(x), tpack(y))) == (X - Y) % P).all()
    assert (tunpack(gl.mul(tpack(x), tpack(y))) == (X * Y) % P).all()


def test_goldilocks_digits_bits_and_roots():
    rng = np.random.default_rng(11)
    n = 300
    x = rng.integers(0, P, size=n, dtype=np.uint64)
    y = rng.integers(0, P, size=n, dtype=np.uint64)
    got = tunpack(gl.dot(tpack(x), tpack(y), axis=-1))
    assert int(got) == sum(int(a) * int(b) for a, b in zip(x, y)) % P
    assert int(tunpack(gl.sum_axis(tpack(x)))) == sum(int(v) for v in x) % P

    v = rand_gl(rng, 40)
    bits = gl.to_bits(tpack(v), 64)
    jbits = jgl.to_bits(jpack(v), 64)
    assert all(np.array_equal(b.numpy(), np.asarray(jb)) for b, jb in zip(bits, jbits))
    for nlog in [0, 1, 4, 12, 13, 16]:
        assert gl.primitive_root_of_unity(nlog) == jgl.primitive_root_of_unity(nlog)


def qe_tpack(c0, c1):
    return (tpack(c0), tpack(c1))


def qe_jpack(c0, c1):
    return (jpack(c0), jpack(c1))


def qe_eq(got, want):
    return (np.array_equal(tunpack(got[0]), junpack(want[0]))
            and np.array_equal(tunpack(got[1]), junpack(want[1])))


def test_extension_ops_match_reference():
    rng = np.random.default_rng(5)
    a = [rand_gl(rng, 40) for _ in range(2)]
    b = [np.flip(rand_gl(rng, 40)) for _ in range(2)]
    ta, tb = qe_tpack(*a), qe_tpack(*b)
    ja, jb = qe_jpack(*a), qe_jpack(*b)
    assert qe_eq(qe.mul(ta, tb), jqe.mul(ja, jb))
    assert qe_eq(qe.add(ta, tb), jqe.add(ja, jb))
    assert qe_eq(qe.sub(ta, tb), jqe.sub(ja, jb))
    inv = qe.mul(ta, qe.inv(ta))  # a * a^-1 == 1 (0 maps to 0)
    nonzero = (a[0] != 0) | (a[1] != 0)
    assert (tunpack(inv[0]) == nonzero).all() and (tunpack(inv[1]) == 0).all()
    eb = (tb, ta)
    got = qe.ea_mul((ta, tb), eb)
    want = jqe.ea_mul((ja, jb), (jb, ja))
    assert qe_eq(got[0], want[0]) and qe_eq(got[1], want[1])

    # stacked-axis helpers on (5, 8) arrays
    m = [rng.integers(0, P, size=(5, 8), dtype=np.uint64) for _ in range(2)]
    x = [rng.integers(0, P, size=(5,), dtype=np.uint64) for _ in range(2)]
    tm, jm = qe_tpack(*m), qe_jpack(*m)
    tx, jx = qe_tpack(*x), qe_jpack(*x)
    assert qe_eq(qe.horner(tm, tx), jqe.horner(jm, jx))
    assert qe_eq(qe.powers(tx, 7), jqe.powers(jx, 7))
    # products and sums along the axis against Python ints
    mi = [v.astype(object) for v in m]
    prod, total = [(1, 0)] * 5, [(0, 0)] * 5
    for b in range(5):
        for k in range(8):
            a0, a1 = prod[b]
            b0, b1 = int(mi[0][b, k]), int(mi[1][b, k])
            prod[b] = ((a0 * b0 + 7 * a1 * b1) % P, (a0 * b1 + a1 * b0) % P)
            total[b] = ((total[b][0] + b0) % P, (total[b][1] + b1) % P)
    got_p, got_s = qe.prod_axis(tm), qe.sum_axis(tm)
    assert [tuple(map(int, t)) for t in zip(tunpack(got_p[0]), tunpack(got_p[1]))] == prod
    assert [tuple(map(int, t)) for t in zip(tunpack(got_s[0]), tunpack(got_s[1]))] == total


def test_extension_reference_vectors():
    # test_goldilocks.py: reference quadratic-extension vectors
    a = qe_tpack([4994088319481652598], [16489566008211790727])
    b = qe_tpack([3797605683985595697], [13424401189265534004])
    c = qe.mul(a, b)
    assert tunpack(c[0])[0] == 15052319864161058789
    assert tunpack(c[1])[0] == 16841416332519902625
    b = qe_tpack([7166004739148609569], [14655965871663555016])
    c = qe.div(a, b)
    assert tunpack(c[0])[0] == 15052319864161058789
    assert tunpack(c[1])[0] == 16841416332519902625


def bn_rand(rng, n):
    BP = bn254.P
    vals = [int(rng.integers(0, 2**62)) ** 5 % BP for _ in range(n)]
    return vals + [0, 1, BP - 1, BP - 2, bn254.R_MOD_P]


def bn_limbs(ints):
    return np.asarray([bn254.int_to_limbs(v) for v in ints], dtype=np.uint32)


def test_bn254_ops_match_reference():
    rng = np.random.default_rng(9)
    xs, ys = bn_rand(rng, 40), bn_rand(rng, 40)[::-1]
    X, Y = bn_limbs(xs), bn_limbs(ys)
    tx = torch.as_tensor(X.astype(np.int64))
    ty = torch.as_tensor(Y.astype(np.int64))
    got = bn254.mont_mul(tx, ty).numpy().astype(np.uint32)
    want = np.asarray(jbn.mont_mul(jnp.asarray(X), jnp.asarray(Y)))
    assert np.array_equal(got, want)
    got = bn254.add(tx, ty).numpy().astype(np.uint32)
    assert np.array_equal(got, np.asarray(jbn.add(jnp.asarray(X), jnp.asarray(Y))))
    assert np.array_equal(bn254.eq(tx, ty).numpy(),
                          np.asarray(jbn.eq(jnp.asarray(X), jnp.asarray(Y))))
    # Python-int truth (test_bn254.py)
    rinv = pow(bn254.R, -1, bn254.P)
    for x, y, g in zip(xs, ys, got.tolist()):
        assert bn254.limbs_to_int(g) == (x + y) % bn254.P
    prod = bn254.mont_mul(tx, ty).tolist()
    for x, y, g in zip(xs, ys, prod):
        assert bn254.limbs_to_int(g) == (x * y * rinv) % bn254.P
    assert bn254.int_to_mont_limbs(12345) == jbn.int_to_mont_limbs(12345)
