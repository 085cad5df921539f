"""The verifier's sequential chains, which the JAX package writes as
``jax.lax.scan`` and the port runs on the card as CUDA kernels: the plain
versions (the CPU path of each public function) against the JAX package's
functions on the same inputs, and the wrappers' contract on the CPU.

- ``goldilocks_ext.horner_plain`` / ``powers_plain`` / ``inv_plain`` against
  ``plonky2_tpu.fields.goldilocks_ext.horner`` / ``powers`` / ``inv``, at
  every broadcast pattern the verifier calls them with (B=2), with the edge
  values 0, 1, p-1, 2^32-1, 2^32 and p-2^32 in both coefficients;
- ``poseidon_gl.hash_no_pad_plain`` against
  ``plonky2_tpu.hash.poseidon_gl.hash_no_pad`` at n = 0, 1, 7, 8, 9, 36, and
  the transcript kernel's block and mask layout for it (``hash_absorb``)
  through the plain sponge (``sponge_plain``);
- on CPU tensors the public functions launch nothing, the kernel wrappers
  raise ``KernelError``, and a tensor on another device never reaches a
  plain version.

The arithmetic is modular and integer, so every comparison is exact: no
tolerance applies.  The kernels themselves are held against the plain
versions on the card (``tests/test_torch_kernels_cuda.py``, ``cuda``)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plonky2_tpu.fields import goldilocks_ext as jqe
from plonky2_tpu.hash import poseidon_gl as jpgl
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.fields import goldilocks_ext as qe
from plonky2_tpu_torch.hash import poseidon_gl as pgl
from plonky2_tpu_torch.kernels import build
from plonky2_tpu_torch.kernels import goldilocks_ext as kq
from plonky2_tpu_torch.kernels import launches
from plonky2_tpu_torch.kernels import poseidon_gl_transcript as kt

torch.set_num_threads(1)
P = gl.P
EDGE = np.array([0, 1, P - 1, (1 << 32) - 1, 1 << 32, P - (1 << 32)],
                dtype=np.uint64)
B = 2


def rand_qe(rng, shape, zero_lanes=0):
    """Random QE values (c0, c1) as uint64 arrays of ``shape``; the first
    elements take every pair of edge values but (0, 0) (as far as they
    reach), and the last ``zero_lanes`` elements are 0."""
    c0 = np.array(rng.integers(0, P, size=shape, dtype=np.uint64))
    c1 = np.array(rng.integers(0, P, size=shape, dtype=np.uint64))
    f0, f1 = c0.reshape(-1), c1.reshape(-1)
    pairs = [(a, b) for a in EDGE for b in EDGE if a or b][:f0.size]
    for i, (a, b) in enumerate(pairs):
        f0[i], f1[i] = a, b
    if zero_lanes:
        f0[-zero_lanes:] = 0
        f1[-zero_lanes:] = 0
    return c0, c1


def tsplit(vals):
    """uint64 array -> GL pair of its shape (0-d included)."""
    return tuple(t.reshape(np.shape(vals)) for t in gl.split_u64(vals))


def tq(v):
    return (tsplit(v[0]), tsplit(v[1]))


def jsplit(vals):
    vals = np.asarray(vals, dtype=np.uint64)
    return (jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((vals >> np.uint64(32)).astype(np.uint32)))


def jq(v):
    return (jsplit(v[0]), jsplit(v[1]))


def junpack(a):
    return (np.asarray(a[0], np.uint64)
            | (np.asarray(a[1], np.uint64) << np.uint64(32)))


def same(got, want):
    """A port QE value equals a JAX QE value, coefficient for coefficient."""
    for g, w in zip(got, want):
        gv, wv = gl.join_u64(g), junpack(w)
        if gv.shape != wv.shape or not np.array_equal(gv, wv):
            return False
    return True


# (terms shape, x shape) of every horner call of a verification at B=2
# (the call sites: gates/gates.py:150 and :353, plonk_checks/vanishing.py:89
# and :96, fri/verify.py:147, :148 and :249), step's sizes and
# decode_block's final polynomial; the terms broadcast against x at the last.
HORNER_SHAPES = [((B, 63), ()), ((B, 4, 4), ()), ((B, 145), (B,)),
                 ((B, 2, 8), (B, 1)), ((B, 258), (B,)), ((B, 2), (B,)),
                 ((B, 1, 32), (B, 28)), ((B, 1, 16), (B, 28))]


@pytest.mark.parametrize("shapes", HORNER_SHAPES,
                         ids=[f"{t}-{x}" for t, x in HORNER_SHAPES])
def test_horner_plain_matches_reference(shapes):
    t_shape, x_shape = shapes
    rng = np.random.default_rng(sum(t_shape) + 7 * len(x_shape))
    terms, x = rand_qe(rng, t_shape), rand_qe(rng, x_shape)
    got = qe.horner_plain(tq(terms), tq(x))
    assert same(got, jqe.horner(jq(terms), jq(x)))
    assert got[0][0].shape == torch.broadcast_shapes(t_shape[:-1], x_shape)


# fri/verify.py:193 and :208 (n0 = 258 on step, 257 on decode_block, and
# num_challenges = 2), and n = 1.
@pytest.mark.parametrize("n", [1, 2, 257, 258])
def test_powers_plain_matches_reference(n):
    rng = np.random.default_rng(n)
    x = rand_qe(rng, (B + 6,))  # 8 lanes: the edge pairs with 0 and 1 first
    got = qe.powers_plain(tq(x), n)
    assert got[0][0].shape == (B + 6, n)
    assert same(got, jqe.powers(jq(x), n))


# plonk_checks/vanishing.py:49, fri/verify.py:201 and :215, :288 and :295
# (B=2); each with lanes of 0, which give 0.
@pytest.mark.parametrize("shape", [(B,), (B, 28), (B, 28, 16)])
def test_inv_plain_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    zero = 1 if len(shape) == 1 else 5
    a = rand_qe(rng, shape, zero_lanes=zero)
    got = qe.inv_plain(tq(a))
    assert same(got, jqe.inv(jq(a)))
    flat = [gl.join_u64(c).reshape(-1) for c in got]
    assert all((c[-zero:] == 0).all() for c in flat)
    # a a^-1 = 1 off the zero lanes
    one = qe.mul(tq(a), got)
    assert (gl.join_u64(one[0]).reshape(-1)[:-zero] == 1).all()
    assert (gl.join_u64(one[1]).reshape(-1)[:-zero] == 0).all()


def _pi_inputs(n, lead=(B,)):
    rng = np.random.default_rng(100 + n)
    vals = rng.integers(0, P, size=lead + (n,), dtype=np.uint64)
    flat = vals.reshape(-1)
    flat[:min(flat.size, EDGE.size)] = EDGE[:flat.size]
    return vals


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 36])
def test_hash_no_pad_plain_matches_reference(n):
    vals = _pi_inputs(n)
    got = gl.join_u64(pgl.hash_no_pad_plain(gl.split_u64(vals)))
    want = junpack(jpgl.hash_no_pad(jsplit(vals)))
    assert got.shape == (B, 4) and np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 36])
def test_sponge_layout_of_hash_no_pad(n):
    """The blocks and mask that the transcript kernel takes for the hash,
    run through the plain sponge: words 0..3 of the last state are
    hash_no_pad_plain, for a lead shape of two dimensions too."""
    for lead in ((B,), (B, 3)):
        inputs = gl.split_u64(_pi_inputs(n, lead))
        absorb, mask = kt.hash_absorb(inputs)
        n_perms = -(-n // 8)
        assert absorb[0].shape == (n_perms, 8, int(np.prod(lead)))
        assert mask.dtype == torch.uint8
        assert mask.reshape(-1).tolist() == [int(i < n)
                                             for i in range(8 * n_perms)]
        states = kt.sponge_plain(absorb, mask)
        got = tuple(s[-1, :, :4].reshape(lead + (4,)) for s in states)
        want = pgl.hash_no_pad_plain(inputs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_public_functions_launch_nothing_on_the_cpu():
    """On CPU tensors the public functions take the plain versions, equal
    to them, and no kernel counter moves."""
    launches.reset()
    rng = np.random.default_rng(5)
    terms, x = tq(rand_qe(rng, (B, 9))), tq(rand_qe(rng, (B,)))
    pi = gl.split_u64(_pi_inputs(9))
    pairs = [(qe.horner(terms, x), qe.horner_plain(terms, x)),
             (qe.powers(x, 5), qe.powers_plain(x, 5)),
             (qe.inv(x), qe.inv_plain(x))]
    for got, want in pairs:
        assert all(torch.equal(g, w) for gc, wc in zip(got, want)
                   for g, w in zip(gc, wc))
    got, want = pgl.hash_no_pad(pi), pgl.hash_no_pad_plain(pi)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert set(launches.read().values()) == {0}


def _zeros_qe(shape, device):
    return qe.zeros(shape, device)


@pytest.mark.parametrize("wrapper", ["horner", "powers", "inv", "hash"])
def test_kernel_wrappers_raise_for_a_cpu_tensor(wrapper):
    calls = {
        "horner": lambda d: kq.horner(_zeros_qe((B, 3), d), _zeros_qe((B,), d)),
        "powers": lambda d: kq.powers(_zeros_qe((B,), d), 3),
        "inv": lambda d: kq.inv(_zeros_qe((B,), d)),
        "hash": lambda d: kt.hash_no_pad_kernel(gl.zeros((B, 9), d)),
    }
    with pytest.raises(build.KernelError):
        calls[wrapper]("cpu")


@pytest.mark.parametrize("fn", ["horner", "powers", "inv", "hash_no_pad"])
def test_public_functions_have_no_fallback_off_the_cpu(fn):
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel's wrapper, which launches or raises (here a meta tensor,
    which has no kernel)."""
    d = "meta"
    calls = {
        "horner": lambda: qe.horner(_zeros_qe((B, 3), d), _zeros_qe((B,), d)),
        "powers": lambda: qe.powers(_zeros_qe((B,), d), 3),
        "inv": lambda: qe.inv(_zeros_qe((B,), d)),
        "hash_no_pad": lambda: pgl.hash_no_pad(gl.zeros((B, 9), d)),
    }
    with pytest.raises(build.KernelError):
        calls[fn]()
