"""Plonky2 gate-constraint evaluators on torch tensors.

Counterpart of ``plonky2_tpu/gates/gates.py``.  Each gate is a function
``eval(consts, wires, pi_hash) -> QE array`` evaluated at zeta:

- ``consts``: QE array (B, n_consts), selector prefix removed;
- ``wires``: QE array (B, n_wires);
- ``pi_hash``: GL pair (B, 4);
- returns a QE array (B, n_gate_constraints) in the reference's order.

Every per-op / per-copy / per-round repetition is a stacked tensor axis.
Sequences whose intermediates the proof pins to witness wires (Poseidon
S-box inputs, reducing accumulators, exponentiation intermediates) are not
sequential for the verifier; the coset-interpolation chunk steps are one
CUDA kernel launch on the card (``coset_interp_scan``) and a short Python
loop on the CPU (``coset_interp_scan_plain``).  Gate instances are parsed
from plonky2's Rust Debug-string gate IDs by the registry at the end of
this module.
"""

from __future__ import annotations

import functools
import re

import numpy as np
import torch

from ..fields import goldilocks as gl
from ..fields import goldilocks_ext as qe
from ..hash import poseidon_gl_constants as PK
from ..hash.poseidon_gl import _mds_layer

UNUSED_SELECTOR = (1 << 32) - 1
D = 2


# ---------------------------------------------------------------------------
# Small helpers over QE arrays
# ---------------------------------------------------------------------------

def _w(wires, i):
    return qe.index(wires, (Ellipsis, i))


def _ws(wires, sl):
    if isinstance(sl, tuple):
        return qe.index(wires, sl)
    return qe.index(wires, (Ellipsis, sl))


def _col(x):
    return qe.index(x, (Ellipsis, None))


def _map4(fn, *arrs):
    """Apply fn to the four limb planes of QE arrays in lockstep."""
    return ((fn(*[a[0][0] for a in arrs]), fn(*[a[0][1] for a in arrs])),
            (fn(*[a[1][0] for a in arrs]), fn(*[a[1][1] for a in arrs])))


def _interleave2(a, b):
    """Two QE arrays (B, n) -> (B, 2n) interleaved [a0, b0, a1, b1, ...]."""
    return _map4(lambda x, y: torch.stack([x, y], dim=-1).reshape(
        x.shape[:-1] + (-1,)), a, b)


def _interleave_many(arrs):
    return _map4(lambda *xs: torch.stack(xs, dim=-1).reshape(
        xs[0].shape[:-1] + (-1,)), *arrs)


def _flatten2(a):
    """QE array (B, m, n) -> (B, m*n) row-major."""
    return _map4(lambda x: x.reshape(x.shape[:-2] + (-1,)), a)


def _qe_const(values, like):
    """Python ints -> constant QE tensor (component 1 zero) on like's device."""
    c0 = gl.const_like(gl.const_array(values), like)
    return (c0, gl.zeros_like(c0))


def _ea_cols(wires, start, count, stride=D):
    """Extension-algebra columns: [y.c0, y.c1] at start + stride*i ->
    (QE (B, count), QE (B, count))."""
    i0 = _ws(wires, slice(start, start + stride * count, stride))
    i1 = _ws(wires, slice(start + 1, start + 1 + stride * count, stride))
    return (i0, i1)


def _add_gl_const(x, garr):
    """QE array + constant base-field GL array: into component 0 only."""
    return (gl.add(x[0], gl.const_like(garr, x[0][0])), x[1])


def _qe_int(v, like):
    return qe.from_ints(v, 0, (), like.device)


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------

class ArithmeticGate:
    """const_0 * m0 * m1 + const_1 * addend == out, num_ops copies."""

    def __init__(self, num_ops):
        self.num_ops = num_ops

    def eval(self, consts, wires, pi_hash):
        n = self.num_ops
        c0, c1 = _col(_w(consts, 0)), _col(_w(consts, 1))
        m0 = _ws(wires, slice(0, 4 * n, 4))
        m1 = _ws(wires, slice(1, 4 * n, 4))
        addend = _ws(wires, slice(2, 4 * n, 4))
        out = _ws(wires, slice(3, 4 * n, 4))
        computed = qe.add(qe.mul(qe.mul(m0, m1), c0), qe.mul(addend, c1))
        return qe.sub(out, computed)


class ArithmeticExtensionGate:
    """The same over extension-algebra wires."""

    def __init__(self, num_ops):
        self.num_ops = num_ops

    def eval(self, consts, wires, pi_hash):
        n = self.num_ops
        c0, c1 = _col(_w(consts, 0)), _col(_w(consts, 1))
        m0 = _ea_cols(wires, 0, n, 4 * D)
        m1 = _ea_cols(wires, D, n, 4 * D)
        addend = _ea_cols(wires, 2 * D, n, 4 * D)
        out = _ea_cols(wires, 3 * D, n, 4 * D)
        computed = qe.ea_add(qe.ea_scalar_mul(c1, addend),
                             qe.ea_scalar_mul(c0, qe.ea_mul(m0, m1)))
        diff = qe.ea_sub(out, computed)
        return _interleave2(diff[0], diff[1])


class BaseSumGate:
    """sum == sum_i limb_i base^i, plus a per-limb range product."""

    def __init__(self, num_limbs, base):
        self.num_limbs = num_limbs
        self.base = base

    def eval(self, consts, wires, pi_hash):
        like = wires[0][0]
        total = _col(_w(wires, 0))
        limbs = _ws(wires, slice(1, 1 + self.num_limbs))     # (B, L)
        computed = qe.horner(limbs, _qe_int(self.base, like))
        first = qe.sub(_col(computed), total)                # (B, 1)
        acc = qe.ones_like(limbs)
        for i in range(self.base):
            acc = qe.mul(acc, qe.sub(limbs, _qe_int(i, like)))
        return qe.concat([first, acc])


class ConstantGate:
    """wire_out[i] == constant[i]."""

    def __init__(self, num_consts):
        self.num_consts = num_consts

    def eval(self, consts, wires, pi_hash):
        n = self.num_consts
        return qe.sub(qe.index(consts, (Ellipsis, slice(0, n))),
                      qe.index(wires, (Ellipsis, slice(0, n))))


def coset_interp_scan(inter_eval, inter_prod, values, pt, schedule):
    """The interpolation gate's chunk steps from its wires: chunk 0 starts
    at ev = 0, pr = 1, chunk c >= 1 at (inter_eval, inter_prod)[..., c - 1]
    (EA (B, C - 1)); step j of chunk c takes values[..., vidx[j, c]] (EA (B,
    n)); pt EA (B, 1); schedule: the gate's host schedule (numpy,
    ``CosetInterpolationGate.schedule``).  One CUDA kernel launch on a CUDA
    tensor, the schedule passed by value; the plain version on a CPU
    tensor.  Returns (ev, pr) EA (B, C)."""
    k = gl.mul_kernels(values[0][0][0])
    if k is None:
        return coset_interp_scan_plain(*coset_interp_scan_operands(
            inter_eval, inter_prod, values, pt, schedule))
    return k.coset_interp_scan(inter_eval, inter_prod, values, pt, schedule)


def coset_interp_scan_operands(inter_eval, inter_prod, values, pt, schedule):
    """``coset_interp_scan``'s arguments -> ``coset_interp_scan_plain``'s:
    ev, pr EA (B, C) with chunk 0 at (0, 1), the values gathered to EA (B,
    deg, C), pt, and the schedule's xs, ws and active mask as tensors on
    the values' device."""
    xs, ws, vidx, active = schedule
    like = values[0][0][0]
    B = like.shape[0]
    z1 = qe.zeros((B, 1), like.device)
    o1 = qe.ones((B, 1), like.device)
    ev = (qe.concat([z1, inter_eval[0]]), qe.concat([z1, inter_eval[1]]))
    pr = (qe.concat([o1, inter_prod[0]]), qe.concat([z1, inter_prod[1]]))
    vidx_t = gl.device_table(vidx, like.device)
    val = (qe.index(values[0], (Ellipsis, vidx_t)),
           qe.index(values[1], (Ellipsis, vidx_t)))
    return (ev, pr, val, pt, gl.const_like(xs, like), gl.const_like(ws, like),
            gl.device_table(active, like.device))


def coset_interp_scan_plain(ev, pr, val, pt, xs, ws, active):
    """The deg steps of every chunk at once (JAX: the ``jax.lax.scan`` of
    ``plonky2_tpu/gates/gates.py`` CosetInterpolationGate.eval).

    ev, pr: EA (B, C), the chunks' running evaluation and product; val: EA
    (B, deg, C), the values taken at each step; pt: EA (B, 1), the shifted
    evaluation point; xs, ws: GL (deg, C), each step's domain point and
    barycentric weight; active: bool (deg, C).  Step j, where active:
    term = pt - xs[j] (in the base coordinate of the first QE),
    ev = ev term + val[:, j] ws[j] pr, pr = pr term.  Returns (ev, pr)."""
    for j in range(xs[0].shape[0]):
        x = gl.index(xs, j)
        wgt = gl.index(ws, j)
        vj = (qe.index(val[0], (Ellipsis, j, slice(None))),
              qe.index(val[1], (Ellipsis, j, slice(None))))
        term = ((gl.sub(pt[0][0], x), pt[0][1]), pt[1])
        wv = ((gl.mul(vj[0][0], wgt), gl.mul(vj[0][1], wgt)),
              (gl.mul(vj[1][0], wgt), gl.mul(vj[1][1], wgt)))
        new_ev = qe.ea_add(qe.ea_mul(ev, term), qe.ea_mul(wv, pr))
        new_pr = qe.ea_mul(pr, term)
        m = active[j][None, :]
        ev = (qe.select(m, new_ev[0], ev[0]), qe.select(m, new_ev[1], ev[1]))
        pr = (qe.select(m, new_pr[0], pr[0]), qe.select(m, new_pr[1], pr[1]))
    return ev, pr


class CosetInterpolationGate:
    """Chunked barycentric interpolation over a coset of H.  Chunks are
    independent for the verifier (each chunk's accumulator init is pinned to
    intermediate wires), so they stack into an axis; the <= degree steps
    within a chunk run as ``coset_interp_scan``."""

    def __init__(self, subgroup_bits, degree, barycentric_weights):
        self.subgroup_bits = subgroup_bits
        self.degree = degree
        self.weights = barycentric_weights

    @property
    def num_points(self):
        return 1 << self.subgroup_bits

    @property
    def num_intermediates(self):
        return (self.num_points - 2) // (self.degree - 1)

    @functools.cached_property
    def schedule(self):
        """The static per-(step, chunk) schedule, numpy (deg, C): domain
        points and weights as GL (lo, hi) pairs, value indices, and the
        active mask."""
        n = self.num_points
        deg = self.degree
        ni = self.num_intermediates
        C = 1 + ni
        domain = gl.two_adic_subgroup(self.subgroup_bits)
        bounds = [(0, deg)]
        for i in range(ni):
            s = 1 + (deg - 1) * (i + 1)
            bounds.append((s, min(s + deg - 1, n)))
        xs = np.zeros((deg, C), dtype=object)
        ws = np.zeros((deg, C), dtype=object)
        vidx = np.zeros((deg, C), dtype=np.int64)
        active = np.zeros((deg, C), dtype=bool)
        for c, (s, e) in enumerate(bounds):
            for j in range(e - s):
                xs[j, c] = domain[s + j]
                ws[j, c] = self.weights[s + j] % gl.P
                vidx[j, c] = s + j
                active[j, c] = True
        return (gl.const_array(xs.tolist()), gl.const_array(ws.tolist()),
                vidx, active)

    def eval(self, consts, wires, pi_hash):
        n = self.num_points
        ni = self.num_intermediates
        C = 1 + ni
        start_values = 1
        start_eval_point = start_values + n * D
        start_eval_value = start_eval_point + D
        start_intermediates = start_eval_value + D

        shift = _w(wires, 0)
        eval_point = (_w(wires, start_eval_point), _w(wires, start_eval_point + 1))
        shifted_pt = (_w(wires, start_intermediates + D * 2 * ni),
                      _w(wires, start_intermediates + D * 2 * ni + 1))

        # constraints 0-1: evaluation_point - shift * shifted_evaluation_point
        neg_shift = qe.neg(shift)
        c_shift = qe.ea_add((qe.mul(neg_shift, shifted_pt[0]),
                             qe.mul(neg_shift, shifted_pt[1])), eval_point)

        values = _ea_cols(wires, start_values, n)            # ea (B, n)
        inter_eval = _ea_cols(wires, start_intermediates, ni)
        inter_prod = _ea_cols(wires, start_intermediates + D * ni, ni)
        pt = (_col(shifted_pt[0]), _col(shifted_pt[1]))      # ea (B, 1)
        ev, pr = coset_interp_scan(inter_eval, inter_prod, values, pt,
                                   self.schedule)

        out = [qe.stack([c_shift[0], c_shift[1]], axis=-1)]
        if ni:
            de = qe.ea_sub(inter_eval, (qe.index(ev[0], (Ellipsis, slice(0, ni))),
                                        qe.index(ev[1], (Ellipsis, slice(0, ni)))))
            dp = qe.ea_sub(inter_prod, (qe.index(pr[0], (Ellipsis, slice(0, ni))),
                                        qe.index(pr[1], (Ellipsis, slice(0, ni)))))
            out.append(_interleave_many([de[0], de[1], dp[0], dp[1]]))
        eval_value = (_w(wires, start_eval_value), _w(wires, start_eval_value + 1))
        dv = qe.ea_sub(eval_value, (qe.index(ev[0], (Ellipsis, C - 1)),
                                    qe.index(ev[1], (Ellipsis, C - 1))))
        out.append(qe.stack([dv[0], dv[1]], axis=-1))
        return qe.concat(out)


class ExponentiationGate:
    """Square-and-multiply chain; every intermediate is a wire."""

    def __init__(self, num_power_bits):
        self.num_power_bits = num_power_bits

    def eval(self, consts, wires, pi_hash):
        npb = self.num_power_bits
        like = wires[0][0]
        B = like.shape[0]
        base = _col(_w(wires, 0))
        output = _w(wires, 1 + npb)
        inters = _ws(wires, slice(2 + npb, 2 + 2 * npb))      # (B, npb)
        # cur_bit for step i is power_bits[npb - 1 - i]: wires npb .. 1
        cur_bits = _ws(wires, (Ellipsis, torch.arange(npb, 0, -1,
                                                      device=like.device)))
        head = qe.index(inters, (Ellipsis, slice(0, npb - 1)))
        prev = qe.concat([qe.ones((B, 1), like.device), qe.mul(head, head)])
        one = qe.ones((B, npb), like.device)
        mul_by = qe.sub(qe.mul(cur_bits, base), qe.sub(cur_bits, one))
        steps = qe.sub(qe.mul(prev, mul_by), inters)
        last = qe.sub(output, qe.index(inters, (Ellipsis, npb - 1)))
        return qe.concat([steps, _col(last)])


class MulExtensionGate:
    """const_0 * m0 * m1 == out over the extension algebra."""

    def __init__(self, num_ops):
        self.num_ops = num_ops

    def eval(self, consts, wires, pi_hash):
        n = self.num_ops
        c0 = _col(_w(consts, 0))
        m0 = _ea_cols(wires, 0, n, 3 * D)
        m1 = _ea_cols(wires, D, n, 3 * D)
        out = _ea_cols(wires, 2 * D, n, 3 * D)
        computed = qe.ea_scalar_mul(c0, qe.ea_mul(m0, m1))
        diff = qe.ea_sub(out, computed)
        return _interleave2(diff[0], diff[1])


class NoopGate:
    def eval(self, consts, wires, pi_hash):
        return qe.zeros((wires[0][0].shape[0], 0), wires[0][0].device)


class PublicInputGate:
    """wires[0..4] == public-inputs-hash elements."""

    def eval(self, consts, wires, pi_hash):
        return qe.sub(qe.index(wires, (Ellipsis, slice(0, 4))),
                      qe.from_base(pi_hash))


class RandomAccessGate:
    """Mux-tree list access."""

    def __init__(self, bits, num_copies, num_extra_constants):
        self.bits = bits
        self.num_copies = num_copies
        self.num_extra_constants = num_extra_constants

    @property
    def vec_size(self):
        return 1 << self.bits

    def eval(self, consts, wires, pi_hash):
        C, V, nb = self.num_copies, self.vec_size, self.bits
        like = wires[0][0]
        stride = 2 + V
        num_routed = stride * C + self.num_extra_constants

        access = _ws(wires, slice(0, stride * C, stride))     # (B, C)
        claimed = _ws(wires, slice(1, stride * C, stride))    # (B, C)
        item_idx = gl.device_table([[stride * c + 2 + i for i in range(V)]
                                    for c in range(C)], like.device)
        items = _ws(wires, (Ellipsis, item_idx))              # (B, C, V)
        bit_idx = gl.device_table([[num_routed + c * nb + i for i in range(nb)]
                                   for c in range(C)], like.device)
        bits = _ws(wires, (Ellipsis, bit_idx))                # (B, C, nb)

        bools = qe.sub(qe.mul(bits, bits), bits)
        recon = qe.horner(bits, _qe_int(2, like))             # (B, C)
        c_recon = qe.sub(recon, access)
        for lvl in range(nb):
            b = _col(qe.index(bits, (Ellipsis, lvl)))         # (B, C, 1)
            evens = qe.index(items, (Ellipsis, slice(0, None, 2)))
            odds = qe.index(items, (Ellipsis, slice(1, None, 2)))
            items = qe.add(evens, qe.mul(b, qe.sub(odds, evens)))
        c_mux = qe.sub(qe.index(items, (Ellipsis, 0)), claimed)

        # per-copy block: [bools.., recon, mux] -> (B, C, nb + 2) row-major
        block = qe.concat([bools, _col(c_recon), _col(c_mux)], axis=-1)
        out = [_flatten2(block)]
        ne = self.num_extra_constants
        if ne:
            out.append(qe.sub(qe.index(consts, (Ellipsis, slice(0, ne))),
                              _ws(wires, slice(stride * C, stride * C + ne))))
        return qe.concat(out)


class ReducingGate:
    """Horner accumulation with base-field coefficients; all accumulators
    are wires, so the chain vectorizes over the coefficient axis."""

    def __init__(self, num_coeffs):
        self.num_coeffs = num_coeffs

    def _accs(self, wires, start_accs):
        n = self.num_coeffs
        final = (_w(wires, 0), _w(wires, 1))
        inters = _ea_cols(wires, start_accs, n - 1)
        old = (_w(wires, 2 * D), _w(wires, 2 * D + 1))
        src = (qe.concat([_col(old[0]), inters[0]]),
               qe.concat([_col(old[1]), inters[1]]))
        tgt = (qe.concat([inters[0], _col(final[0])]),
               qe.concat([inters[1], _col(final[1])]))
        return src, tgt

    def eval(self, consts, wires, pi_hash):
        n = self.num_coeffs
        start_coeffs = 3 * D
        alpha = (_col(_w(wires, D)), _col(_w(wires, D + 1)))
        coeffs = _ws(wires, slice(start_coeffs, start_coeffs + n))   # (B, n)
        src, tgt = self._accs(wires, start_coeffs + n)
        coeff_ea = (coeffs, qe.zeros_like(coeffs))
        tmp = qe.ea_sub(qe.ea_add(qe.ea_mul(src, alpha), coeff_ea), tgt)
        return _interleave2(tmp[0], tmp[1])


class ReducingExtensionGate:
    """Horner accumulation with extension coefficients."""

    def __init__(self, num_coeffs):
        self.num_coeffs = num_coeffs

    def eval(self, consts, wires, pi_hash):
        n = self.num_coeffs
        start_coeffs = 3 * D
        alpha = (_col(_w(wires, D)), _col(_w(wires, D + 1)))
        coeffs = _ea_cols(wires, start_coeffs, n)
        src, tgt = ReducingGate._accs(self, wires, start_coeffs + n * D)
        tmp = qe.ea_sub(qe.ea_add(qe.ea_mul(src, alpha), coeffs), tgt)
        return _interleave2(tmp[0], tmp[1])


def _mds12_qe(x):
    """Width-12 MDS over a QE array (..., 12): both components together."""
    glp = (torch.stack([x[0][0], x[1][0]], dim=-2),
           torch.stack([x[0][1], x[1][1]], dim=-2))            # (..., 2, 12)
    out = _mds_layer(glp)
    return ((out[0][..., 0, :], out[1][..., 0, :]),
            (out[0][..., 1, :], out[1][..., 1, :]))


class PoseidonMdsGate:
    """One MDS layer over an extension-algebra width-12 state."""

    WIDTH = 12

    def eval(self, consts, wires, pi_hash):
        W = self.WIDTH
        inp = _ea_cols(wires, 0, W)                           # ea (B, 12)
        out = _ea_cols(wires, W * D, W)
        glp = (torch.stack([inp[0][0][0], inp[0][1][0],
                            inp[1][0][0], inp[1][1][0]], dim=-2),
               torch.stack([inp[0][0][1], inp[0][1][1],
                            inp[1][0][1], inp[1][1][1]], dim=-2))  # (B, 4, 12)
        m = _mds_layer(glp)
        computed = (((m[0][..., 0, :], m[1][..., 0, :]),
                     (m[0][..., 1, :], m[1][..., 1, :])),
                    ((m[0][..., 2, :], m[1][..., 2, :]),
                     (m[0][..., 3, :], m[1][..., 3, :])))
        diff = qe.ea_sub(out, computed)
        return _interleave2(diff[0], diff[1])


@functools.lru_cache(maxsize=1)
def _poseidon_tables():
    """PoseidonGate constants: round constants and the composed partial-round
    maps (precomputed host-side, as in the reference)."""
    P = gl.P
    W, NP = PoseidonGate.WIDTH, PoseidonGate.N_PARTIAL
    rc = [PK.ALL_ROUND_CONSTANTS[i] for i in range(30 * W)]
    rc_first = [[rc[i + W * r] for i in range(W)] for r in range(4)]
    rc_second = [[rc[i + W * (26 + r)] for i in range(W)] for r in range(4)]
    pc = [PK.FAST_PARTIAL_ROUND_CONSTANTS[r] if r < NP - 1 else 0
          for r in range(NP)]
    whats = PK.FAST_PARTIAL_ROUND_W_HATS                  # (22, 11)
    vs = PK.FAST_PARTIAL_ROUND_VS                         # (22, 11)
    init = PK.FAST_PARTIAL_ROUND_INITIAL_MATRIX           # (11, 11) [r-1][d-1]
    init_t = [[init[r][d] % P for r in range(11)] for d in range(11)]
    # vw[r][j] = what_r . vs_j for j < r (composition of sparse updates)
    vw = [[0] * NP for _ in range(NP)]
    for r in range(NP):
        for j in range(r):
            vw[r][j] = sum(whats[r][i] * vs[j][i] for i in range(11)) % P
    vs_t = [[vs[j][i] % P for j in range(NP)] for i in range(11)]
    return dict(
        rc_first=[gl.const_array(r) for r in rc_first],
        rc_rest=gl.const_array(rc_first[1:]),
        rc_second=gl.const_array(rc_second),
        first_const=gl.const_array(PK.FAST_PARTIAL_FIRST_ROUND_CONSTANT),
        pc=gl.const_array(pc),
        init_t=gl.const_array(init_t),
        whats=gl.const_array([[x % P for x in row] for row in whats]),
        vw=gl.const_array(vw),
        vs_t=gl.const_array(vs_t),
        mds0to0=PK.MDS0TO0,
    )


class PoseidonGate:
    """Full Poseidon permutation as constraints, with S-box inputs pinned to
    witness wires each round.  No round depends on another round's computed
    output: the full rounds evaluate as one stacked (B, 4, 12) S-box + MDS,
    and the 22 partial rounds reduce to closed-form linear algebra over the
    22 S-box outputs."""

    WIDTH = 12
    HALF_FULL = 4
    N_PARTIAL = 22

    def w_output(self, i):
        return self.WIDTH + i

    @property
    def w_swap(self):
        return 2 * self.WIDTH

    def w_delta(self, i):
        return 2 * self.WIDTH + 1 + i

    def w_full0(self, round_, i):
        return 2 * self.WIDTH + 5 + (round_ - 1) * self.WIDTH + i

    def w_partial(self, round_):
        return 2 * self.WIDTH + 5 + (self.HALF_FULL - 1) * self.WIDTH + round_

    def w_full1(self, round_, i):
        return (2 * self.WIDTH + 5 + (self.HALF_FULL - 1) * self.WIDTH
                + self.N_PARTIAL + round_ * self.WIDTH + i)

    @staticmethod
    def _sbox(x):
        """x^7 elementwise on a QE array."""
        x2 = qe.mul(x, x)
        x4 = qe.mul(x2, x2)
        x3 = qe.mul(x, x2)
        return qe.mul(x4, x3)

    def eval(self, consts, wires, pi_hash):
        C = _poseidon_tables()
        W, NP = self.WIDTH, self.N_PARTIAL
        like = wires[0][0]
        B = like.shape[0]
        out = []

        def idx(rows):
            return gl.device_table(rows, like.device)

        swap = _w(wires, self.w_swap)
        one = qe.ones((B,), like.device)
        out.append(_col(qe.mul(swap, qe.sub(swap, one))))

        lhs = _ws(wires, slice(0, 4))
        rhs = _ws(wires, slice(4, 8))
        deltas = _ws(wires, slice(self.w_delta(0), self.w_delta(0) + 4))
        out.append(qe.sub(qe.mul(_col(swap), qe.sub(rhs, lhs)), deltas))

        state0 = qe.concat([qe.add(lhs, deltas), qe.sub(rhs, deltas),
                            _ws(wires, slice(8, 12))])        # (B, 12)

        # ---- first full rounds, stacked over the round axis
        w_full0 = _ws(wires, (Ellipsis, idx(
            [[self.w_full0(r, i) for i in range(W)] for r in range(1, 4)])))
        a0 = _add_gl_const(state0, C["rc_first"][0])          # (B, 12)
        Xin = _map4(lambda f, r: torch.cat([f[:, None, :], r], dim=1),
                    a0, w_full0)                              # (B, 4, 12)
        Y = _mds12_qe(self._sbox(Xin))

        pre = _add_gl_const(qe.index(Y, (Ellipsis, slice(0, 3), slice(None))),
                            C["rc_rest"])
        out.append(_flatten2(qe.sub(pre, w_full0)))           # (B, 36)

        # ---- partial rounds
        t = _add_gl_const(qe.index(Y, (Ellipsis, 3, slice(None))),
                          C["first_const"])
        s0_init = qe.index(t, (Ellipsis, 0))
        rest_init = qe.matmul_const(qe.index(t, (Ellipsis, slice(1, None))),
                                    C["init_t"])              # (B, 11)

        wp = _ws(wires, slice(self.w_partial(0), self.w_partial(0) + NP))
        s0 = _add_gl_const(self._sbox(wp), C["pc"])           # (B, 22)
        d = qe.add(qe.scalar_mul_const(s0, C["mds0to0"]),
                   qe.add(qe.matmul_const(rest_init, C["whats"]),
                          qe.matmul_const(s0, C["vw"])))      # (B, 22)
        out.append(qe.concat([
            _col(qe.sub(s0_init, qe.index(wp, (Ellipsis, 0)))),
            qe.sub(qe.index(d, (Ellipsis, slice(0, NP - 1))),
                   qe.index(wp, (Ellipsis, slice(1, None))))]))

        d_last = qe.index(d, (Ellipsis, NP - 1))
        R = qe.add(rest_init, qe.matmul_const(s0, C["vs_t"]))  # (B, 11)
        exit_state = qe.concat([_col(d_last), R])

        # ---- second full rounds
        w_full1 = _ws(wires, (Ellipsis, idx(
            [[self.w_full1(r, i) for i in range(W)] for r in range(4)])))
        Z = _mds12_qe(self._sbox(w_full1))                    # (B, 4, 12)
        pre1 = _map4(lambda f, r: torch.cat([f[:, None, :], r], dim=1),
                     exit_state, qe.index(Z, (Ellipsis, slice(0, 3), slice(None))))
        pre1 = _add_gl_const(pre1, C["rc_second"])
        out.append(_flatten2(qe.sub(pre1, w_full1)))          # (B, 48)

        outputs = _ws(wires, slice(self.w_output(0), self.w_output(0) + W))
        out.append(qe.sub(qe.index(Z, (Ellipsis, 3, slice(None))), outputs))
        return qe.concat(out)


# ---------------------------------------------------------------------------
# Registry: parse plonky2 Rust Debug-string gate IDs (the same table as the
# reference package's)
# ---------------------------------------------------------------------------

_REGISTRY = [
    (re.compile(r"ArithmeticGate { num_ops: (\d+) }"),
     lambda m: ArithmeticGate(int(m.group(1)))),
    (re.compile(r"ArithmeticExtensionGate { num_ops: (\d+) }"),
     lambda m: ArithmeticExtensionGate(int(m.group(1)))),
    (re.compile(r"BaseSumGate { num_limbs: (\d+) } \+ Base: (\d+)"),
     lambda m: BaseSumGate(int(m.group(1)), int(m.group(2)))),
    (re.compile(r"ConstantGate { num_consts: (\d+) }"),
     lambda m: ConstantGate(int(m.group(1)))),
    (re.compile(r"CosetInterpolationGate { subgroup_bits: (\d+), degree: (\d+),"
                r" barycentric_weights: \[([0-9, ]+)\]"),
     lambda m: CosetInterpolationGate(
         int(m.group(1)), int(m.group(2)),
         [int(x.strip()) for x in m.group(3).split(",")])),
    (re.compile(r"ExponentiationGate { num_power_bits: (\d+)"),
     lambda m: ExponentiationGate(int(m.group(1)))),
    (re.compile(r"MulExtensionGate { num_ops: (\d+) }"),
     lambda m: MulExtensionGate(int(m.group(1)))),
    (re.compile(r"NoopGate"), lambda m: NoopGate()),
    (re.compile(r"PoseidonMdsGate"), lambda m: PoseidonMdsGate()),
    (re.compile(r"PoseidonGate"), lambda m: PoseidonGate()),
    (re.compile(r"PublicInputGate"), lambda m: PublicInputGate()),
    (re.compile(r"RandomAccessGate { bits: (\d+), num_copies: (\d+), "
                r"num_extra_constants: (\d+)"),
     lambda m: RandomAccessGate(int(m.group(1)), int(m.group(2)),
                                int(m.group(3)))),
    (re.compile(r"ReducingExtensionGate { num_coeffs: (\d+) }"),
     lambda m: ReducingExtensionGate(int(m.group(1)))),
    (re.compile(r"ReducingGate { num_coeffs: (\d+) }"),
     lambda m: ReducingGate(int(m.group(1)))),
]


def gate_from_id(gate_id):
    for regex, ctor in _REGISTRY:
        m = regex.search(gate_id)
        if m:
            return ctor(m)
    raise ValueError(f"Unknown gate ID {gate_id}")


# ---------------------------------------------------------------------------
# Selector filtering + constraint accumulation
# ---------------------------------------------------------------------------

def evaluate_gate_constraints(gates, selector_indices, groups,
                              num_gate_constraints, local_constants,
                              local_wires, pi_hash):
    """local_constants, local_wires: QE arrays (B, n).  Returns a QE array
    (B, num_gate_constraints): filtered, summed gate constraints at zeta."""
    num_selectors = len(groups)
    like = local_constants[0][0]
    B = like.shape[0]
    accum = qe.zeros((B, num_gate_constraints), like.device)
    consts = qe.index(local_constants, (Ellipsis, slice(num_selectors, None)))
    for row, gate in enumerate(gates):
        sel_idx = selector_indices[row]
        group_start, group_end = groups[sel_idx]
        s = _col(qe.index(local_constants, (Ellipsis, sel_idx)))
        terms = [i for i in range(group_start, group_end) if i != row]
        if num_selectors > 1:
            terms.append(UNUSED_SELECTOR)
        # filter = prod_i (term_i - s)
        filt = qe.prod_axis(qe.sub(_qe_const(terms, like), s))  # (B,)

        unfiltered = gate.eval(consts, local_wires, pi_hash)      # (B, k)
        k = unfiltered[0][0].shape[-1]
        if k == 0:
            continue
        assert k <= num_gate_constraints, "gate produced too many constraints"
        contrib = qe.mul(unfiltered, _col(filt))
        head = qe.add(qe.index(accum, (Ellipsis, slice(0, k))), contrib)
        accum = qe.concat([head, qe.index(accum, (Ellipsis, slice(k, None)))])
    return accum
