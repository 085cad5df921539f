"""The CIOS kernel's limb-level algorithm (``csrc/poseidon_bn254_cios.cu``)
as a Python-int model: 9 limbs of 29 bits, products summed into 64-bit
columns, the squaring's doubled cross terms, the Montgomery reduction by
2^261 limb by limb and its carry pass, the entry shift by 2^5 and the exit
product by 2^256 mod p, and both kernels' rounds: the group kernel (a lane's
four threads each holding one element, the partial rounds' row terms summed
by two shuffle-xor steps on the limbs) and the lane kernel (one thread, each
linear-layer output one pass of four products).  Every bound that the
source's header states is asserted where the kernel holds the value, and
the model equals ``permute_plain``.  The model exists only in this test; on
the card the CUDA kernel is held against ``permute_plain``
(tests/test_torch_kernels_cuda.py, chip_smoke.py).  The arithmetic is
integer and exact: no tolerance applies.
"""
import numpy as np
import pytest
import torch

from plonky2_tpu_torch.fields import bn254
from plonky2_tpu_torch.kernels import poseidon_bn254 as kb
from plonky2_tpu_torch.kernels import poseidon_bn254_cios as kc

torch.set_num_threads(1)
P = bn254.P
NL, LB = 9, 29
LM = (1 << LB) - 1
R2 = 1 << (NL * LB)  # the kernel's Montgomery radix 2^261
N0 = (-pow(P, -1, 1 << LB)) % (1 << LB)
WIDTH, HALF, PARTIAL = 4, 4, 56
COL_MAX = 1 << 64


def limbs(x):
    assert 0 <= x < R2
    return [(x >> (LB * k)) & LM for k in range(NL)]


def value(ls):
    return sum(v << (LB * k) for k, v in enumerate(ls))


def mul_add(cols, a, b):
    assert max(a + b) <= LM
    for i in range(NL):
        for j in range(NL):
            cols[i + j] += a[i] * b[j]


def sqr_add(cols, a):
    assert max(a) <= LM
    for i in range(NL):
        cols[2 * i] += a[i] * a[i]
        for j in range(i + 1, NL):
            cols[i + j] += (2 * a[i]) * a[j]  # 2 a_i < 2^30


def redc(cols, add=None, fits=True):
    """(cols + m p) / 2^261 + add, normalised, as the kernel's redc; with
    ``fits`` the result is below 2^261, so its top limb fits 29 bits."""
    p = limbs(P)
    before = value(cols)
    ms = 0
    for i in range(NL):
        m = (cols[i] * N0) & LM
        ms += m << (LB * i)
        for j in range(NL):
            cols[i + j] += m * p[j]
        assert max(cols) < COL_MAX
        assert cols[i] % (1 << LB) == 0
        cols[i + 1] += cols[i] >> LB
    assert ms < R2 and (before + ms * P) % R2 == 0
    for k in range(NL):
        cols[NL + k] += (add or [0] * NL)[k]
    out = []
    for k in range(NL, 2 * NL - 1):
        cols[k + 1] += cols[k] >> LB
        out.append(cols[k] & LM)
    assert cols[2 * NL - 1] <= LM or not fits
    out.append(cols[2 * NL - 1])
    assert value(out) == (before + ms * P) // R2 + value(add or [0] * NL)
    return out


def mont(a, b, add=None):
    cols = [0] * (2 * NL)
    mul_add(cols, a, b)
    assert max(cols) < 18 << 58
    out = redc(cols, add)
    assert value(out) < value(a) * value(b) // R2 + P + value(add or [0] * NL)
    return out


def msqr(a):
    cols = [0] * (2 * NL)
    sqr_add(cols, a)
    assert value(cols) == value(a) ** 2
    return redc(cols)


def pass4(consts, ys):
    """sum_j c_j y_j / 2^261 + k p: four products into the same columns."""
    cols = [0] * (2 * NL)
    for c, y in zip(consts, ys):
        mul_add(cols, c, y)
    out = redc(cols)
    assert max(value(c) for c in consts) < P
    return out


def exp5_add(x, c):
    x2 = msqr(x)
    x4 = msqr(x2)
    y = mont(x4, x, c)
    assert value(y) - value(c) < 1.3 * P and value(y) < 2.3 * P
    return y


def carry(ls):
    assert max(ls) < 1 << 32
    v = value(ls)
    assert v < R2
    return limbs(v)


def consts():
    """The kernel's constant buffer (``const_limbs``) by OFF_* name."""
    n = len(kb.const_elements())
    flat = kc.const_limbs(n).view(np.uint32).reshape(n, NL)
    els = [[int(v) for v in row] for row in flat]
    names = [("ark0", 4), ("ark_first", 16), ("ark_second", 16), ("m", 16),
             ("p", 16), ("part_c", 56), ("s_row", 224), ("s_col", 168)]
    out, at = {}, 0
    for name, k in names:
        out[name] = els[at:at + k]
        at += k
    return out


def load_element(x, a):
    """Canonical x 2^256 mod p -> x 2^261 (a shift by 5) + a, below 33p."""
    s = carry([u + v for u, v in zip(limbs(x << 5), a)])
    assert value(s) < 33 * P
    return s


def store_element(s):
    assert value(s) < 58 * P
    c = mont(s, limbs(pow(2, 256, P)))
    assert value(c) < 1.01 * P
    v = value(c)
    return v - P if v >= P else v


def full_round_group(group, C, ark, mat):
    """Thread e: its S-box; the group exchanges them; thread i: output i."""
    ys = [exp5_add(s, C[ark[0]][ark[1] + e]) for e, s in enumerate(group)]
    return [pass4([C[mat][j * WIDTH + i] for j in range(WIDTH)], ys)
            for i in range(WIDTH)]


def partial_round_group(group, s0, C, r):
    """Every thread: y = s0^5 + c; thread e: its row term and, e > 0,
    s_e + y col_e; the row terms summed by two shuffle-xor steps."""
    y = exp5_add(s0, C["part_c"][r])
    rows, new = [], []
    for e in range(WIDTH):
        a = y if e == 0 else group[e]
        rows.append(mont(a, C["s_row"][r * WIDTH + e]))
        assert value(rows[-1]) < 1.35 * P
        new.append(mont(y, C["s_col"][r * 3 + (e - 1 if e else 0)], group[e]))
    step1 = [[u + v for u, v in zip(rows[e], rows[e ^ 1])] for e in range(WIDTH)]
    step2 = [[u + v for u, v in zip(step1[e], step1[e ^ 2])] for e in range(WIDTH)]
    assert max(max(v) for v in step2) < 1 << 31
    s0s = [carry(v) for v in step2]
    assert all(v == s0s[0] for v in s0s)  # every thread holds the new s0
    assert value(s0s[0]) < 5.1 * P
    return [s0s[0]] + new[1:], s0s[0]


def permute_group(lane, C):
    group = [load_element(x, C["ark0"][e]) for e, x in enumerate(lane)]
    for r in range(HALF):
        group = full_round_group(group, C, ("ark_first", r * WIDTH),
                                 "p" if r == HALF - 1 else "m")
        assert all(value(s) < 1.08 * P for s in group)
    s0 = group[0]
    for r in range(PARTIAL):
        group, s0 = partial_round_group(group, s0, C, r)
        assert all(value(s) < 58 * P for s in group)
    for r in range(HALF):
        group = full_round_group(group, C, ("ark_second", r * WIDTH), "m")
        assert all(value(s) < 1.08 * P for s in group)
    return [store_element(s) for s in group]


def permute_lane(lane, C):
    s = [load_element(x, C["ark0"][e]) for e, x in enumerate(lane)]

    def full(s, ark, mat):
        ys = [exp5_add(v, C[ark[0]][ark[1] + e]) for e, v in enumerate(s)]
        return [pass4([C[mat][j * WIDTH + i] for j in range(WIDTH)], ys)
                for i in range(WIDTH)]

    for r in range(HALF):
        s = full(s, ("ark_first", r * WIDTH), "p" if r == HALF - 1 else "m")
    for r in range(PARTIAL):
        s[0] = exp5_add(s[0], C["part_c"][r])
        new0 = pass4(C["s_row"][r * WIDTH:(r + 1) * WIDTH], s)
        assert value(new0) < 5.1 * P
        for k in range(1, WIDTH):
            s[k] = mont(s[0], C["s_col"][r * 3 + k - 1], s[k])
        s[0] = new0
        assert all(value(v) < 58 * P for v in s)
    for r in range(HALF):
        s = full(s, ("ark_second", r * WIDTH), "m")
    return [store_element(v) for v in s]


def _lanes():
    rng = np.random.default_rng(43)
    lanes = [[0, 1, P - 1, 2], [P - 1] * 4, [0] * 4]
    lanes += [[int.from_bytes(rng.bytes(32), "little") % P for _ in range(4)]
              for _ in range(2)]
    return lanes


@pytest.mark.parametrize("kernel", [permute_group, permute_lane],
                         ids=["group", "lane"])
@pytest.mark.parametrize("lane", _lanes(), ids=lambda lane: hex(lane[0])[:8])
def test_limb_model_equals_permute_plain(kernel, lane):
    state = torch.as_tensor(np.asarray(
        [[bn254.int_to_limbs(x) for x in lane]], np.int64))
    want = [bn254.limbs_to_int(x) for x in kb.permute_plain(state).numpy()[0]]
    assert kernel(lane, consts()) == want


def test_bounds_hold_at_the_extremes():
    """Limbs all 2^29 - 1 push every column to its largest value; state
    values at the stated bounds keep their products inside theirs."""
    top = [LM] * NL
    cols = [0] * (2 * NL)
    for _ in range(WIDTH):
        mul_add(cols, top, top)
    assert max(cols) == 36 * LM * LM
    redc(cols, fits=False)  # asserts every column < 2^64 with m p's terms
    cols = [0] * (2 * NL)
    sqr_add(cols, top)
    assert max(cols) <= 9 * LM * LM + 8 * LM
    redc(cols, fits=False)
    c = limbs(P - 1)
    for s, bound in [(58, 1.35), (33, 1.2), (5.1, 1.04), (2.3, 1.02)]:
        assert value(mont(limbs(int(s * P)), c)) < bound * P
    assert value(msqr(limbs(33 * P))) < 7.5 * P
    assert value(msqr(limbs(58 * P))) < 21 * P
    assert value(mont(limbs(int(3.6 * P)), limbs(58 * P))) < 2.3 * P
    assert value(mont(limbs(58 * P), limbs(pow(2, 256, P)))) < 1.01 * P


def test_const_limbs_are_the_constants_times_32():
    n = len(kb.const_elements())
    flat = kc.const_limbs(n).view(np.uint32).reshape(n, NL)
    for row, c in zip(flat, kb.const_elements()):
        assert value([int(v) for v in row]) == \
            (bn254.limbs_to_int(c) << 5) % P
    with pytest.raises(kc.build.KernelError):
        kc.const_limbs(n + 1)
