"""Goldilocks quadratic extension F_p[X]/(X^2 - 7) and the degree-2
extension algebra over it, on torch tensors.

Counterpart of ``plonky2_tpu/fields/goldilocks_ext.py``: a QE value is a pair
``(c0, c1)`` of base elements (each a (lo, hi) pair of int64 tensors); an
extension-algebra value is a pair of QE values.

The sequential chains that the JAX package writes as ``jax.lax.scan``
(``horner``, ``powers``, and ``inv`` through the base field's inversion)
run on the card as the CUDA kernels of ``kernels/goldilocks_ext.py``; their
plain versions (``horner_plain``, ``powers_plain``, ``inv_plain``) are
Python loops of torch ops, taken only for CPU tensors.  The product ``mul``
and ``mul_add`` launch the kernel of ``kernels/goldilocks_mul.py`` on a
CUDA tensor (so ``square``, ``div``, ``prod_axis`` and the extension
algebra's products do too); the chains' plain versions call ``mul_plain``
and ``mul_add_plain``, so they stay plain torch on any device.
"""

from __future__ import annotations

import torch

from . import goldilocks as gl


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def from_base(a):
    return (a, gl.zeros_like(a))


def from_ints(c0, c1, shape=(), device="cpu"):
    return (gl.from_int(c0, shape, device), gl.from_int(c1, shape, device))


def zeros(shape=(), device="cpu"):
    return (gl.zeros(shape, device), gl.zeros(shape, device))


def ones(shape=(), device="cpu"):
    return (gl.ones(shape, device), gl.zeros(shape, device))


def zeros_like(a):
    return (gl.zeros_like(a[0]), gl.zeros_like(a[0]))


def ones_like(a):
    return (gl.ones_like(a[0]), gl.zeros_like(a[0]))


def device_of(a):
    return a[0][0].device


# ---------------------------------------------------------------------------
# Ring ops
# ---------------------------------------------------------------------------

def add(a, b):
    return (gl.add(a[0], b[0]), gl.add(a[1], b[1]))


def sub(a, b):
    return (gl.sub(a[0], b[0]), gl.sub(a[1], b[1]))


def neg(a):
    return (gl.neg(a[0]), gl.neg(a[1]))


def _mul_digits(a, b):
    d0 = gl.add_digits(gl.mul_digits(a[0], b[0]),
                       gl.scale_digits(gl.mul_digits(a[1], b[1]), gl.W))
    d1 = gl.add_digits(gl.mul_digits(a[0], b[1]), gl.mul_digits(a[1], b[0]))
    return d0, d1


def mul(a, b):
    """a b: one CUDA kernel launch on a CUDA tensor, the plain version on a
    CPU tensor."""
    k = gl.mul_kernels(a[0][0])
    return mul_plain(a, b) if k is None else k.qe_mul(a, b)


def mul_plain(a, b):
    """(a0 + a1 X)(b0 + b1 X) = (a0 b0 + 7 a1 b1) + (a0 b1 + a1 b0) X."""
    d0, d1 = _mul_digits(a, b)
    return (gl.reduce_digits(d0), gl.reduce_digits(d1))


def mul_add(a, b, c):
    """a b + c: one CUDA kernel launch on a CUDA tensor, the plain version
    on a CPU tensor."""
    k = gl.mul_kernels(a[0][0])
    return mul_add_plain(a, b, c) if k is None else k.qe_mul(a, b, c)


def mul_add_plain(a, b, c):
    d0, d1 = _mul_digits(a, b)
    return (gl.reduce_digits(gl.add_to_digits(d0, c[0])),
            gl.reduce_digits(gl.add_to_digits(d1, c[1])))


def square(a):
    return mul(a, a)


def scalar_mul_const(a, c):
    return (gl.mul_const(a[0], c), gl.mul_const(a[1], c))


def _kernels(a):
    """The CUDA kernels' module for a value on a GPU, None on the CPU."""
    if device_of(a).type == "cpu":
        return None
    from ..kernels import goldilocks_ext
    return goldilocks_ext


def inv(a):
    """a^-1 elementwise, 0 for 0: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    k = _kernels(a)
    return inv_plain(a) if k is None else k.inv(a)


def inv_plain(a):
    """a^-1 = conj(a) / N(a), conj(a) = (a0, DTH_ROOT * a1); 0 for 0."""
    conj = (a[0], gl.mul_const_plain(a[1], gl.DTH_ROOT))
    norm = gl.reduce_digits(
        gl.add_digits(gl.mul_digits(a[0], conj[0]),
                      gl.scale_digits(gl.mul_digits(a[1], conj[1]), gl.W)))
    norm_inv = gl.inv_plain(norm)
    return (gl.mul_plain(conj[0], norm_inv), gl.mul_plain(conj[1], norm_inv))


def div(a, b):
    return mul(a, inv(b))


def is_zero(a):
    return gl.is_zero(a[0]) & gl.is_zero(a[1])


def eq(a, b):
    return gl.eq(a[0], b[0]) & gl.eq(a[1], b[1])


def select(mask, a, b):
    return (gl.select(mask, a[0], b[0]), gl.select(mask, a[1], b[1]))


# ---------------------------------------------------------------------------
# Stacked-axis helpers
# ---------------------------------------------------------------------------

def stack(values, axis=-1):
    return (gl.stack([v[0] for v in values], axis),
            gl.stack([v[1] for v in values], axis))


def concat(arrs, axis=-1):
    return (gl.concat([a[0] for a in arrs], axis),
            gl.concat([a[1] for a in arrs], axis))


def index(a, idx):
    return (gl.index(a[0], idx), gl.index(a[1], idx))


def reshape(a, shape):
    return (gl.reshape(a[0], shape), gl.reshape(a[1], shape))


def horner(terms, x):
    """sum_i terms[..., i] * x^i over the last axis: the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor.

    terms: QE (..., n); x: QE broadcastable to (...)."""
    k = _kernels(terms)
    return horner_plain(terms, x) if k is None else k.horner(terms, x)


def horner_plain(terms, x):
    """sum_i terms[..., i] * x^i over the last axis.

    terms: QE (..., n); x: QE broadcastable to (...)."""
    n = terms[0][0].shape[-1]
    lead = torch.broadcast_shapes(terms[0][0].shape[:-1], x[0][0].shape)
    acc = zeros(lead, device_of(terms))
    for i in reversed(range(n)):
        acc = mul_add_plain(acc, x, index(terms, (Ellipsis, i)))
    return acc


def powers(x, n):
    """[x^0, .., x^(n-1)] as a QE array (..., n): the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    k = _kernels(x)
    return powers_plain(x, n) if k is None else k.powers(x, n)


def powers_plain(x, n):
    """[x^0, .., x^(n-1)] as a QE array (..., n)."""
    out = [ones_like(x)]
    for _ in range(n - 1):
        out.append(mul_plain(out[-1], x))
    return stack(out[:n], axis=-1)


def prod_axis(a, axis=-1):
    """Product along the last axis by log-depth pairwise folding."""
    assert axis == -1
    n = a[0][0].shape[-1]
    while n > 1:
        if n % 2:
            a = concat([a, ones(a[0][0].shape[:-1] + (1,), device_of(a))])
            n += 1
        a = mul(index(a, (Ellipsis, slice(0, None, 2))),
                index(a, (Ellipsis, slice(1, None, 2))))
        n //= 2
    return index(a, (Ellipsis, 0))


def sum_axis(a, axis=-1):
    return (gl.sum_axis(a[0], axis), gl.sum_axis(a[1], axis))


def mul_const_arr(a, const_arr):
    """QE (..., n) times a constant base-field array (n,) elementwise."""
    c = gl.const_like(const_arr, a[0][0])
    return (gl.mul(a[0], c), gl.mul(a[1], c))


def matmul_const(x, m_const):
    return (gl.matmul_const(x[0], m_const), gl.matmul_const(x[1], m_const))


# ---------------------------------------------------------------------------
# Extension algebra: degree-2 polynomials over QE modulo Y^2 - 7
# ---------------------------------------------------------------------------

def ea_add(a, b):
    return (add(a[0], b[0]), add(a[1], b[1]))


def ea_sub(a, b):
    return (sub(a[0], b[0]), sub(a[1], b[1]))


def ea_mul(a, b):
    """(a0 + a1 Y)(b0 + b1 Y) mod (Y^2 - 7)."""
    c0 = add(mul(a[0], b[0]), scalar_mul_const(mul(a[1], b[1]), gl.W))
    c1 = add(mul(a[0], b[1]), mul(a[1], b[0]))
    return (c0, c1)


def ea_scalar_mul(s, a):
    return (mul(s, a[0]), mul(s, a[1]))
