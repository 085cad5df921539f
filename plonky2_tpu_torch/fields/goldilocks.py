"""Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) on torch tensors.

Counterpart of ``plonky2_tpu/fields/goldilocks.py``.  A value is a pair
``(lo, hi)`` of ``int64`` tensors holding the 32-bit halves of the canonical
(< p) element.  Torch has no unsigned 32/64-bit arithmetic on the CPU, so the
halves live in ``int64`` and every intermediate stays below 2^63: a 32-bit
half times a 16-bit limb is < 2^48, and ``>>`` (an arithmetic shift on
``int64``) is only applied to non-negative values or masked after.

Unreduced accumulators ("digits") are lists of ``int64`` tensors at 16-bit
positions, as in the reference; each digit may grow to ~2^61 before
``reduce_digits`` folds the (< 2^160) value back into canonical form using
2^64 = 2^32 - 1 and 2^96 = -1 (mod p).

Every function takes the device of its inputs; constants are numpy arrays
moved next to the operand that uses them once per device (``device_table``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

P = (1 << 64) - (1 << 32) + 1
EPSILON = (1 << 32) - 1  # 2^64 mod p
MULTIPLICATIVE_GROUP_GENERATOR = 7
TWO_ADICITY = 32
POWER_OF_TWO_GENERATOR = 1753635133440165772
W = 7
DTH_ROOT = 18446744069414584320
D = 2

MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF
I64 = torch.int64


def device_table(x, device, dtype=None):
    """A constant array (numpy, or nested python ints) as a tensor on
    ``device``, copied from host memory once per content and device and
    shared by every caller, who never writes to it.  A copy from host memory
    waits for the device and cannot be captured in a CUDA graph, so after a
    first verification none is left on the path.  Never evicted: a captured
    graph reads the table at its address."""
    arr = np.ascontiguousarray(np.asarray(x, dtype=dtype))
    return _device_table(arr.dtype.str, arr.shape, arr.tobytes(),
                         torch.device(device))


@functools.lru_cache(maxsize=None)
def _device_table(dtype, shape, data, device):
    arr = np.frombuffer(data, dtype=dtype).reshape(shape)
    return torch.from_numpy(arr.copy()).to(device)


def as_tensor(x, like):
    """numpy / python constant -> int64 tensor on ``like``'s device."""
    if isinstance(x, torch.Tensor):
        return x.to(like.device)
    return device_table(x, like.device, np.int64)


# ---------------------------------------------------------------------------
# Construction / conversion
# ---------------------------------------------------------------------------

def from_int(value, shape=(), device="cpu"):
    value = int(value) % P
    return (torch.full(tuple(shape), value & MASK32, dtype=I64, device=device),
            torch.full(tuple(shape), value >> 32, dtype=I64, device=device))


def zeros(shape=(), device="cpu"):
    return (torch.zeros(tuple(shape), dtype=I64, device=device),
            torch.zeros(tuple(shape), dtype=I64, device=device))


def ones(shape=(), device="cpu"):
    return (torch.ones(tuple(shape), dtype=I64, device=device),
            torch.zeros(tuple(shape), dtype=I64, device=device))


def zeros_like(a):
    return (torch.zeros_like(a[0]), torch.zeros_like(a[0]))


def ones_like(a):
    return (torch.ones_like(a[0]), torch.zeros_like(a[0]))


def split_u64(arr, device="cpu"):
    """numpy uint64 array -> (lo, hi) int64 tensors (lossless: the halves are
    taken in numpy through an int64 view, never through a float cast)."""
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.uint64))
    v = arr.view(np.int64)
    lo = v & np.int64(MASK32)
    hi = (v >> np.int64(32)) & np.int64(MASK32)
    return (torch.as_tensor(lo, device=device),
            torch.as_tensor(hi, device=device))


def join_u64(a):
    """(lo, hi) tensors -> numpy uint64 array."""
    lo = a[0].detach().cpu().numpy().astype(np.uint64)
    hi = a[1].detach().cpu().numpy().astype(np.uint64)
    return lo | (hi << np.uint64(32))


# ---------------------------------------------------------------------------
# Reduction core
# ---------------------------------------------------------------------------

def _canon(lo, hi):
    """r < 2^64 as (lo, hi) 32-bit halves -> canonical [0, p)."""
    ge = (hi == MASK32) & (lo != 0)
    return (torch.where(ge, lo - 1, lo), torch.where(ge, torch.zeros_like(hi), hi))


def _fold(L, H):
    """V = L + H * 2^32 with 0 <= L, H < 2^34 -> canonical (lo, hi).

    Each overflow past 2^64 is folded back as EPSILON = 2^64 mod p; after two
    folds H < 2^32 (see the bounds in the comments)."""
    H = H + (L >> 32)
    L = L & MASK32
    e = H >> 32                      # <= 4
    H = H & MASK32
    L = L + e * EPSILON              # < 5 * 2^32
    H = H + (L >> 32)
    L = L & MASK32
    e = H >> 32                      # 0 or 1; if 1 then H <= 3
    H = H & MASK32
    L = L + e * EPSILON              # < 2^33
    H = H + (L >> 32)                # carry only when e == 1, so H < 2^32
    L = L & MASK32
    return _canon(L, H)


def add(a, b):
    return _fold(a[0] + b[0], a[1] + b[1])


def sub(a, b):
    # a - b + 2p with 2p = (2^33 + 2) + (2^33 - 4) * 2^32, both halves >= 0
    return _fold(a[0] - b[0] + ((1 << 33) + 2), a[1] - b[1] + ((1 << 33) - 4))


def neg(a):
    return sub(zeros_like(a), a)


def eq(a, b):
    return (a[0] == b[0]) & (a[1] == b[1])


def is_zero(a):
    return (a[0] == 0) & (a[1] == 0)


def select(mask, a, b):
    """mask ? a : b (mask is a bool tensor broadcastable to the operands)."""
    return (torch.where(mask, a[0], b[0]), torch.where(mask, a[1], b[1]))


# ---------------------------------------------------------------------------
# Digit accumulators
# ---------------------------------------------------------------------------

def _split16(a):
    return (a[0] & MASK16, a[0] >> 16, a[1] & MASK16, a[1] >> 16)


def mul_digits(a, b):
    """128-bit product as 6 digits at 16-bit positions, each < 2^49:
    a's 32-bit halves times b's 16-bit limbs."""
    b0, b1, b2, b3 = _split16(b)
    alo, ahi = a
    return [alo * b0, alo * b1, alo * b2 + ahi * b0, alo * b3 + ahi * b1,
            ahi * b2, ahi * b3]


def mul_const_digits(a, c):
    """Product of element ``a`` with python-int constant c, as digits."""
    c = int(c) % P
    cl = [(c >> (16 * k)) & MASK16 for k in range(4)]
    digits = [None] * 6
    for j, cj in enumerate(cl):
        if cj == 0:
            continue
        for half, pos in ((a[0], j), (a[1], j + 2)):
            t = half * cj
            digits[pos] = t if digits[pos] is None else digits[pos] + t
    z = torch.zeros_like(a[0])
    return [z if d is None else d for d in digits]


def add_digits(x, y):
    n = max(len(x), len(y))
    out = []
    for k in range(n):
        if k >= len(x):
            out.append(y[k])
        elif k >= len(y):
            out.append(x[k])
        else:
            out.append(x[k] + y[k])
    return out


def add_to_digits(acc, a):
    out = list(acc)
    out[0] = out[0] + a[0]
    out[2] = out[2] + a[1]
    return out


def scale_digits(d, c):
    return [x * int(c) for x in d]


def reduce_digits(digits):
    """Fold a digit accumulator (value < 2^160, digits < 2^61) into a
    canonical element."""
    assert len(digits) <= 10, "accumulation too wide for reduce_digits"
    ds = list(digits)
    words = []
    carry = None
    for w in range(5):
        e = ds[2 * w] if 2 * w < len(ds) else None
        o = ds[2 * w + 1] if 2 * w + 1 < len(ds) else None
        x = e
        if o is not None:
            t = (o & MASK16) << 16
            x = t if x is None else x + t
        if carry is not None:
            x = carry if x is None else x + carry
        if x is None:
            words.append(None)
            continue
        words.append(x & MASK32)
        carry = x >> 32
        if o is not None:
            carry = carry + (o >> 16)
    # value < 2^160 by contract, so no carry leaves word 4.
    z = 0
    w0, w1, w2, w3, w4 = [z if w is None else w for w in words]
    # V == w0 + w1*2^32 + w2*(2^32 - 1) - w3 - w4*2^32 (mod p); add 2p
    L = w0 - w2 - w3 + ((1 << 33) + 2)
    H = w1 + w2 - w4 + ((1 << 33) - 4)
    if not isinstance(L, torch.Tensor):  # pragma: no cover - all-constant
        raise TypeError("reduce_digits needs at least one tensor digit")
    if not isinstance(H, torch.Tensor):
        H = torch.full_like(L, H)
    return _fold(L, H)


# ---------------------------------------------------------------------------
# Multiplication and friends
# ---------------------------------------------------------------------------

def mul_kernels(t):
    """The product kernels' module (``kernels/goldilocks_mul.py``) for a
    tensor on a GPU, None for a CPU tensor."""
    if t.device.type == "cpu":
        return None
    from ..kernels import goldilocks_mul
    return goldilocks_mul


def mul(a, b):
    """a b: one CUDA kernel launch on a CUDA tensor, the plain version on a
    CPU tensor."""
    k = mul_kernels(a[0])
    return mul_plain(a, b) if k is None else k.gl_mul(a, b)


def mul_plain(a, b):
    return reduce_digits(mul_digits(a, b))


def mul_const(a, c):
    """a c for a python-int constant c: zeros for c = 0 and ``a`` itself for
    c = 1 on any device, with no launch; otherwise one CUDA kernel launch on
    a CUDA tensor, the plain version on a CPU tensor."""
    c = int(c) % P
    k = mul_kernels(a[0])
    if k is None or c in (0, 1):
        return mul_const_plain(a, c)
    return k.gl_mul_const(a, c)


def mul_const_plain(a, c):
    c = int(c) % P
    if c == 0:
        return zeros_like(a)
    if c == 1:
        return a
    return reduce_digits(mul_const_digits(a, c))


def mul_const_bits(a, c, idx, off, table):
    """a c times each python-int constant table[i] whose bit off + i of the
    GL index ``idx`` is set, over the broadcast of a and idx; a may be None,
    for 1.  One CUDA kernel launch on a CUDA tensor (any c, a table of 1 to
    64 constants), the plain version on a CPU tensor."""
    k = mul_kernels(idx[0])
    if k is None:
        return mul_const_bits_plain(a, c, idx, off, table)
    return k.gl_mul_const(a, c, idx, off, table)


def mul_const_bits_plain(a, c, idx, off, table):
    """``mul_const_bits`` as the JAX package's loops compute it: a product
    by a constant and a select a bit, then the product by c."""
    bits = to_bits(idx, off + len(table))[off:]
    prod = ones_like(idx[0]) if a is None else a
    for i in reversed(range(len(table))):
        prod = select(bits[i].bool(), mul_const_plain(prod, table[i]), prod)
    return mul_const_plain(prod, c)


def mul_add(a, b, c):
    return reduce_digits(add_to_digits(mul_digits(a, b), c))


def square(a):
    return mul(a, a)


def pow_const(a, e, mul_fn=None):
    """a^e by square and multiply, through ``mul_fn`` (default ``mul``)."""
    mul_fn = mul_fn or mul
    e = int(e)
    if e == 0:
        return ones_like(a)
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul_fn(result, base)
        e >>= 1
        if e:
            base = mul_fn(base, base)
    return result


def inv(a):
    """a^(p-2); 0 for input 0 (the reference's semantics)."""
    return pow_const(a, P - 2)


def inv_plain(a):
    """``inv`` through ``mul_plain`` on any device."""
    return pow_const(a, P - 2, mul_plain)


# ---------------------------------------------------------------------------
# Stacked-axis helpers
# ---------------------------------------------------------------------------

def stack(values, axis=-1):
    return (torch.stack([v[0] for v in values], dim=axis),
            torch.stack([v[1] for v in values], dim=axis))


def concat(arrs, axis=-1):
    return (torch.cat([a[0] for a in arrs], dim=axis),
            torch.cat([a[1] for a in arrs], dim=axis))


def index(a, idx):
    return (a[0][idx], a[1][idx])


def reshape(a, shape):
    return (a[0].reshape(shape), a[1].reshape(shape))


def const_array(values):
    """Python ints (flat or nested list) -> (lo, hi) numpy int64 arrays."""
    arr = np.asarray([[int(v) % P for v in row] for row in values]
                     if len(values) and isinstance(values[0], (list, tuple))
                     else [int(v) % P for v in values], dtype=np.uint64)
    v = arr.view(np.int64)
    return (v & np.int64(MASK32), (v >> np.int64(32)) & np.int64(MASK32))


def const_like(c, like):
    """(lo, hi) numpy constant -> tensors on ``like``'s device."""
    return (as_tensor(c[0], like), as_tensor(c[1], like))


def sum_digits_axis(digits, axis):
    return [d.sum(dim=axis) for d in digits]


def sum_axis(a, axis=-1):
    """Modular sum along an axis (< 2^12 terms)."""
    return reduce_digits([a[0].sum(dim=axis), torch.zeros_like(a[0].sum(dim=axis)),
                          a[1].sum(dim=axis)])


def matmul_const(x, m_const):
    """x @ M^T for GL x (..., n) and constant GL matrix M (k, n)."""
    m = const_like(m_const, x[0])
    d = mul_digits((x[0][..., None, :], x[1][..., None, :]), m)
    return reduce_digits(sum_digits_axis(d, -1))


def dot(a, b, axis=-1):
    return reduce_digits(sum_digits_axis(mul_digits(a, b), axis))


# ---------------------------------------------------------------------------
# Bits
# ---------------------------------------------------------------------------

def to_bits(a, n):
    """Little-endian bits [0..n) of a canonical element, as int64 0/1."""
    bits = [(a[0] >> i) & 1 for i in range(min(n, 32))]
    bits += [(a[1] >> i) & 1 for i in range(max(0, n - 32))]
    return bits


# ---------------------------------------------------------------------------
# Host-side helpers (python ints)
# ---------------------------------------------------------------------------

def primitive_root_of_unity(n_log):
    assert n_log <= TWO_ADICITY
    res = POWER_OF_TWO_GENERATOR
    for _ in range(TWO_ADICITY - n_log):
        res = (res * res) % P
    return res


def bitrev_powers(base, n):
    """[base^(2^(n-1-i)) for i < n]: the constants whose product over the
    set bits i < n of an index is base^bitrev_n(index)."""
    return [pow(base, 1 << (n - 1 - i), P) for i in range(n)]


def two_adic_subgroup(n_log):
    g = primitive_root_of_unity(n_log)
    out = [1]
    for _ in range((1 << n_log) - 1):
        out.append((out[-1] * g) % P)
    return out
