"""The split evaluation order of the QE Horner and powers kernels
(``csrc/goldilocks_ext.cu``), which run each lane's chain on a group of G
threads, and the rule that picks G (``kernels/goldilocks_ext.chain_group``).

- ``chain_group``: a power of two from 1 to 32, at most max(n, 1), within
  the thread budget, and its value at each of the main path's call shapes
  at B=256;
- a plain-torch mirror of the kernels' order (x^G by squarings and x^j from
  the same squarings, Horner in x^G over the strided terms t_(j + G k), the
  x^j scaling and the additive tree of ``__shfl_xor_sync``; the powers'
  strided walk) against ``plonky2_tpu.fields.goldilocks_ext.horner`` /
  ``powers`` (JAX on the CPU) and the port's ``horner_plain`` /
  ``powers_plain``, for every G, at 3 lanes with the edge values 0, 1, p-1,
  2^32-1, 2^32, p-2^32 and x = 0 and x = 1.

The arithmetic is modular and integer, so every comparison is exact: no
tolerance applies.  The kernels themselves are held against the plain
versions on the card (``tests/test_torch_kernels_cuda.py``, ``cuda``)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plonky2_tpu.fields import goldilocks_ext as jqe
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.fields import goldilocks_ext as qe
from plonky2_tpu_torch.kernels import build
from plonky2_tpu_torch.kernels import goldilocks_ext as kq

torch.set_num_threads(1)
P = gl.P
EDGE = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, P - (1 << 32)]
GROUPS = [1, 2, 4, 8, 16, 32]
LANES = 3
N_CASES = [1, 2, 4, 8, 31, 32, 33, 63, 145, 258]


def rand_qe(rng, shape):
    """Random QE values (c0, c1) as uint64 arrays; the first elements take
    the edge pairs, in both coefficients."""
    c = [np.array(rng.integers(0, P, size=shape, dtype=np.uint64))
         for _ in range(2)]
    f0, f1 = c[0].reshape(-1), c[1].reshape(-1)
    pairs = [(a, b) for a in EDGE for b in EDGE if a or b]
    for i in range(f0.size):  # each case walks the pairs from its seed on
        f0[i], f1[i] = pairs[(i + int(rng.integers(len(pairs)))) % len(pairs)]
    return c


def x_lanes(rng):
    """x at LANES lanes: 0, 1 and a random value."""
    x = rand_qe(rng, (LANES,))
    x[0][:2] = 0
    x[1][:2] = 0
    x[0][1] = 1
    return x


def tq(v):
    return tuple(tuple(t.reshape(np.shape(c)) for t in gl.split_u64(c))
                 for c in v)


def jq(v):
    return tuple((jnp.asarray((c & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
                  jnp.asarray((c >> np.uint64(32)).astype(np.uint32)))
                 for c in v)


def jvals(a):
    """A JAX QE value -> (c0, c1) uint64 arrays."""
    return [np.asarray(c[0], np.uint64)
            | (np.asarray(c[1], np.uint64) << np.uint64(32)) for c in a]


def tvals(a):
    return [gl.join_u64(c) for c in a]


def same(got, want):
    return all(g.shape == w.shape and np.array_equal(g, w)
               for g, w in zip(got, want))


# -- the mirror of the kernels' order --------------------------------------

def group_powers(x, g):
    """(x^j for j < g on a last axis, y = x^g), as the kernels make them: y
    by log2 g squarings; x^j multiplied by x^(2^s) where bit s of j is set
    and by 1 where it is not."""
    lead = x[0][0].shape
    j = torch.arange(g)
    acc = qe.ones(lead + (g,))
    base = x
    s = 1
    while s < g:
        wide = qe.index(base, (Ellipsis, None))
        acc = qe.mul_plain(acc, qe.select((j & s) != 0, wide,
                                          qe.ones(lead + (1,))))
        base = qe.mul_plain(base, base)
        s *= 2
    return acc, base


def split_horner(terms, x, g):
    """sum_i t_i x^i as a group of g threads computes it: thread j runs
    Horner in y = x^g over t_(j + g k), k from ceil(n / g) - 1 down to 0
    (a term past n is 0), multiplies by x^j, and the group adds its results
    in a tree of xor partners, g/2, .., 1; thread 0 holds the sum."""
    n = terms[0][0].shape[-1]
    steps = -(-n // g)
    lead = terms[0][0].shape[:-1]
    pad = qe.zeros(lead + (steps * g - n,))
    strided = qe.reshape(qe.concat([terms, pad]), lead + (steps, g))
    xj, y = group_powers(x, g)
    y = qe.index(y, (Ellipsis, None))
    acc = qe.zeros(lead + (g,))
    for k in reversed(range(steps)):
        acc = qe.mul_add_plain(acc, y, qe.index(strided, (Ellipsis, k, slice(None))))
    acc = qe.mul_plain(acc, xj)
    off = g // 2
    while off:
        partner = torch.arange(g) ^ off
        acc = qe.add(acc, qe.index(acc, (Ellipsis, partner)))
        off //= 2
    return qe.index(acc, (Ellipsis, 0))


def split_powers(x, n, g):
    """[x^0, .., x^(n-1)] as a group of g threads writes it: thread j writes
    x^(j + g k), k = 0, 1, .., one product by y = x^g a step."""
    p, y = group_powers(x, g)
    y = qe.index(y, (Ellipsis, None))
    cols = []
    for _ in range(-(-n // g)):
        cols.append(p)
        p = qe.mul_plain(p, y)
    return qe.index(qe.concat(cols), (Ellipsis, slice(0, n)))


@pytest.fixture(scope="module")
def cases():
    """{n: (terms, x, JAX horner, JAX powers)} for every n of N_CASES, from
    one call of each JAX function on all cases laid end to end: the terms
    padded with zeros to the longest n (a zero term adds nothing to the
    sum), the powers cut to each n."""
    n_max = max(N_CASES)
    inputs = {}
    for n in N_CASES:
        rng = np.random.default_rng(1000 + n)
        inputs[n] = (rand_qe(rng, (LANES, n)), x_lanes(rng))
    terms = [np.concatenate([np.pad(inputs[n][0][c], ((0, 0), (0, n_max - n)))
                             for n in N_CASES]) for c in range(2)]
    x = [np.concatenate([inputs[n][1][c] for n in N_CASES]) for c in range(2)]
    hor = jvals(jqe.horner(jq(terms), jq(x)))
    pw = jvals(jqe.powers(jq(x), n_max))
    out = {}
    for i, n in enumerate(N_CASES):
        rows = slice(i * LANES, (i + 1) * LANES)
        out[n] = (*inputs[n], [c[rows] for c in hor],
                  [c[rows, :n] for c in pw])
    return out


@pytest.mark.parametrize("n", N_CASES)
def test_split_horner_matches_reference(cases, n):
    terms, x, want, _ = cases[n]
    assert same(tvals(qe.horner_plain(tq(terms), tq(x))), want)
    for g in GROUPS:
        assert same(tvals(split_horner(tq(terms), tq(x), g)), want), g


@pytest.mark.parametrize("n", N_CASES)
def test_split_powers_matches_reference(cases, n):
    _, x, _, want = cases[n]
    assert same(tvals(qe.powers_plain(tq(x), n)), want)
    for g in GROUPS:
        assert same(tvals(split_powers(tq(x), n, g)), want), g


def test_split_horner_of_no_terms_is_zero():
    x = tq(x_lanes(np.random.default_rng(3)))
    terms = qe.zeros((LANES, 0))
    for g in GROUPS:
        assert all(not v.any() for v in tvals(split_horner(terms, x, g)))


# -- the group width --------------------------------------------------------

# (lanes, n) -> G at each call of a verification at B=256: step's Horner
# calls (gates/gates.py:152, :390; plonk_checks/vanishing.py:89, :96;
# fri/verify.py:147, :148, :249, its final polynomial of 32 at 256 x 28
# lanes) and powers (fri/verify.py:193, :208), decode_block's final
# polynomial of 16 and FRI batch of 257.
MAIN_PATH_GROUPS = {(256, 63): 32, (1024, 4): 1, (256, 145): 32,
                    (512, 8): 4, (256, 258): 32, (256, 2): 1,
                    (7168, 32): 4, (7168, 16): 4, (256, 257): 32}


@pytest.mark.parametrize("shape", list(MAIN_PATH_GROUPS),
                         ids=[f"{a}x{b}" for a, b in MAIN_PATH_GROUPS])
def test_chain_group_at_main_path_shapes(shape):
    assert kq.chain_group(*shape) == MAIN_PATH_GROUPS[shape]


def test_chain_group_is_a_power_of_two_within_the_chain():
    for lanes in [1, 2, 3, 31, 256, 257, 1024, 7168, 28672, 10 ** 6]:
        for n in [0, 1, 2, 3, 4, 5, 7, 8, 9, 16, 31, 32, 33, 64, 65, 258,
                  1000, 4096]:
            g = kq.chain_group(lanes, n)
            assert g in GROUPS, (lanes, n, g)
            assert g <= max(n, 1), (lanes, n, g)
            assert g == 1 or lanes * g <= kq.THREAD_BUDGET, (lanes, n, g)


def test_chain_group_takes_the_shortest_chain():
    """Among the widths it may take, no other gives a chain fewer products
    deep: log2 G + ceil(n / G) + 1, and n for G = 1."""
    def depth(g, n):
        return n if g == 1 else g.bit_length() - 1 + -(-n // g) + 1

    for lanes, n in [(256, 258), (7168, 32), (512, 8), (1, 1000), (64, 45)]:
        g = kq.chain_group(lanes, n)
        allowed = [h for h in GROUPS if h <= max(n, 1)
                   and (h == 1 or lanes * h <= kq.THREAD_BUDGET)]
        assert depth(g, n) == min(depth(h, n) for h in allowed), (lanes, n)


@pytest.mark.parametrize("group", [0, 3, 64, -1])
def test_chain_wrappers_refuse_another_group(group):
    with pytest.raises(ValueError):
        kq._group(256, 258, group)


def test_chain_wrappers_take_a_group_and_raise_off_the_card():
    x = tq(x_lanes(np.random.default_rng(4)))
    terms = tq(rand_qe(np.random.default_rng(5), (LANES, 8)))
    with pytest.raises(build.KernelError):
        kq.horner(terms, x, group=4)
    with pytest.raises(build.KernelError):
        kq.powers(x, 8, group=4)
