"""The benchmark's plain reference: a Plonky2 verifier in Python ints.

A frozen copy of the JAX package's ``bench/cpu_reference.py`` (itself an
independent Python-int transcription of gnark-plonky2-verifier
verifier/verifier.go:143-170), kept here so that no later change to either
package moves the yardstick.  It reads the proof JSON as handed to the
system under test, parses the circuit's ``common_circuit_data.json`` itself
(``load_spec``, the gate IDs by ``gate_from_id``) and takes its two constant
tables from this directory.  It imports nothing of ``jax``, of the JAX
package or of the port.

Departures from the copy: ``verify`` returns the PLONK check and the FRI
check (the proof-of-work check with the query rounds) apart, as the port's
``verify_batch(..., diagnostics=True)`` does, and takes ``query_rounds``:
the number of FRI query rounds it checks, all by default; fewer is the
benchmark's control (``reference/control.py``), never the reference.
"""

from __future__ import annotations

import dataclasses
import json
import re

from . import bn254_constants as BK
from . import gl_constants as GK

P = (1 << 64) - (1 << 32) + 1
BN_P = BK.BN254_P
W = 7
TWO_ADICITY = 32
POWER_OF_TWO_GENERATOR = 1753635133440165772
GENERATOR = 7


# ---------------------------------------------------------------------------
# Circuit spec and gate IDs (plonky2's common_circuit_data.json)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CircuitSpec:
    num_wires: int
    num_routed_wires: int
    num_challenges: int
    rate_bits: int
    cap_height: int
    pow_bits: int
    num_query_rounds: int
    degree_bits: int
    reduction_arity_bits: tuple
    gate_ids: tuple
    selector_indices: tuple
    groups: tuple
    quotient_degree_factor: int
    num_gate_constraints: int
    num_constants: int
    num_public_inputs: int
    k_is: tuple
    num_partial_products: int

    @property
    def lde_bits(self):
        return self.degree_bits + self.rate_bits

    def gates(self):
        return [gate_from_id(g) for g in self.gate_ids]


def load_spec(path):
    """``common_circuit_data.json`` -> CircuitSpec."""
    with open(path) as f:
        raw = json.load(f)
    cfg, fri = raw["config"], raw["fri_params"]
    if fri["hiding"]:
        raise ValueError("hiding circuits are not supported")
    sel = raw["selectors_info"]
    return CircuitSpec(
        num_wires=cfg["num_wires"],
        num_routed_wires=cfg["num_routed_wires"],
        num_challenges=cfg["num_challenges"],
        rate_bits=fri["config"]["rate_bits"],
        cap_height=fri["config"]["cap_height"],
        pow_bits=fri["config"]["proof_of_work_bits"],
        num_query_rounds=fri["config"]["num_query_rounds"],
        degree_bits=fri["degree_bits"],
        reduction_arity_bits=tuple(fri["reduction_arity_bits"]),
        gate_ids=tuple(raw["gates"]),
        selector_indices=tuple(sel["selector_indices"]),
        groups=tuple((g["start"], g["end"]) for g in sel["groups"]),
        quotient_degree_factor=raw["quotient_degree_factor"],
        num_gate_constraints=raw["num_gate_constraints"],
        num_constants=raw["num_constants"],
        num_public_inputs=raw["num_public_inputs"],
        k_is=tuple(raw["k_is"]),
        num_partial_products=raw["num_partial_products"],
    )


UNUSED_SELECTOR = (1 << 32) - 1


class _Gate:
    def __init__(self, **fields):
        self.__dict__.update(fields)


class ArithmeticGate(_Gate): pass
class ArithmeticExtensionGate(_Gate): pass
class BaseSumGate(_Gate): pass
class ConstantGate(_Gate): pass
class ExponentiationGate(_Gate): pass
class MulExtensionGate(_Gate): pass
class NoopGate(_Gate): pass
class PoseidonMdsGate(_Gate): pass
class PublicInputGate(_Gate): pass
class RandomAccessGate(_Gate):
    @property
    def vec_size(self):
        return 1 << self.bits

class ReducingExtensionGate(_Gate): pass
class ReducingGate(_Gate): pass


class CosetInterpolationGate(_Gate):
    @property
    def num_points(self):
        return 1 << self.subgroup_bits

    @property
    def num_intermediates(self):
        return (self.num_points - 2) // (self.degree - 1)


class PoseidonGate(_Gate):
    """Wire layout (gnark-plonky2-verifier plonk/gates/poseidon_gate.go:29-90)."""
    WIDTH, HALF_FULL, N_PARTIAL = 12, 4, 22
    w_swap = 2 * WIDTH

    def w_delta(self, i):
        return 2 * self.WIDTH + 1 + i

    def w_full0(self, round_, i):
        return 2 * self.WIDTH + 5 + (round_ - 1) * self.WIDTH + i

    def w_partial(self, round_):
        return 2 * self.WIDTH + 5 + (self.HALF_FULL - 1) * self.WIDTH + round_

    def w_full1(self, round_, i):
        return (2 * self.WIDTH + 5 + (self.HALF_FULL - 1) * self.WIDTH
                + self.N_PARTIAL + round_ * self.WIDTH + i)


def _ints(m, *names):
    return {n: int(m.group(i + 1)) for i, n in enumerate(names)}


_REGISTRY = [
    (r"ArithmeticGate { num_ops: (\d+) }",
     lambda m: ArithmeticGate(**_ints(m, "num_ops"))),
    (r"ArithmeticExtensionGate { num_ops: (\d+) }",
     lambda m: ArithmeticExtensionGate(**_ints(m, "num_ops"))),
    (r"BaseSumGate { num_limbs: (\d+) } \+ Base: (\d+)",
     lambda m: BaseSumGate(**_ints(m, "num_limbs", "base"))),
    (r"ConstantGate { num_consts: (\d+) }",
     lambda m: ConstantGate(**_ints(m, "num_consts"))),
    (r"CosetInterpolationGate { subgroup_bits: (\d+), degree: (\d+),"
     r" barycentric_weights: \[([0-9, ]+)\]",
     lambda m: CosetInterpolationGate(
         subgroup_bits=int(m.group(1)), degree=int(m.group(2)),
         weights=[int(x.strip()) for x in m.group(3).split(",")])),
    (r"ExponentiationGate { num_power_bits: (\d+)",
     lambda m: ExponentiationGate(**_ints(m, "num_power_bits"))),
    (r"MulExtensionGate { num_ops: (\d+) }",
     lambda m: MulExtensionGate(**_ints(m, "num_ops"))),
    (r"NoopGate", lambda m: NoopGate()),
    (r"PoseidonMdsGate", lambda m: PoseidonMdsGate()),
    (r"PoseidonGate", lambda m: PoseidonGate()),
    (r"PublicInputGate", lambda m: PublicInputGate()),
    (r"RandomAccessGate { bits: (\d+), num_copies: (\d+), "
     r"num_extra_constants: (\d+)",
     lambda m: RandomAccessGate(**_ints(m, "bits", "num_copies",
                                        "num_extra_constants"))),
    (r"ReducingExtensionGate { num_coeffs: (\d+) }",
     lambda m: ReducingExtensionGate(**_ints(m, "num_coeffs"))),
    (r"ReducingGate { num_coeffs: (\d+) }",
     lambda m: ReducingGate(**_ints(m, "num_coeffs"))),
]


def gate_from_id(gate_id):
    """plonky2's Rust Debug string of a gate -> its gate object."""
    for pattern, make in _REGISTRY:
        m = re.search(pattern, gate_id)
        if m:
            return make(m)
    raise ValueError(f"unknown gate ID {gate_id}")



# ---------------------------------------------------------------------------
# Goldilocks / QE helpers
# ---------------------------------------------------------------------------

def qe_mul(a, b):
    return ((a[0] * b[0] + W * a[1] * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0]) % P)


def qe_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def qe_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def qe_scalar(a, s):
    return ((a[0] * s) % P, (a[1] * s) % P)


def qe_inv(a):
    # conjugate trick (reference goldilocks/quadratic_extension.go:123-134)
    dth = 18446744069414584320
    conj = (a[0], (a[1] * dth) % P)
    norm = (a[0] * conj[0] + W * a[1] * conj[1]) % P
    ninv = pow(norm, P - 2, P)
    return qe_scalar(conj, ninv)


def qe_div(a, b):
    return qe_mul(a, qe_inv(b))


def qe_exp(a, e):
    out = (1, 0)
    base = a
    while e:
        if e & 1:
            out = qe_mul(out, base)
        e >>= 1
        base = qe_mul(base, base)
    return out


def reduce_with_powers(terms, alpha):
    acc = (0, 0)
    for t in reversed(terms):
        acc = qe_add(qe_mul(acc, alpha), t)
    return acc


def primitive_root_of_unity(n_log):
    res = POWER_OF_TWO_GENERATOR
    for _ in range(TWO_ADICITY - n_log):
        res = res * res % P
    return res


# ---------------------------------------------------------------------------
# Poseidon-GL (width 12) and the duplex challenger
# ---------------------------------------------------------------------------

def poseidon_gl(state):
    state = list(state)
    rc = GK.ALL_ROUND_CONSTANTS
    circ, diag = GK.MDS_MATRIX_CIRC, GK.MDS_MATRIX_DIAG

    def mds(st):
        return [(sum(st[(i + r) % 12] * circ[i] for i in range(12))
                 + st[r] * diag[r]) % P for r in range(12)]

    rctr = 0
    for _ in range(4):
        state = [(x + rc[12 * rctr + i]) % P for i, x in enumerate(state)]
        state = [pow(x, 7, P) for x in state]
        state = mds(state)
        rctr += 1
    state = [(x + GK.FAST_PARTIAL_FIRST_ROUND_CONSTANT[i]) % P
             for i, x in enumerate(state)]
    new = [state[0]] + [
        sum(state[r] * GK.FAST_PARTIAL_ROUND_INITIAL_MATRIX[r - 1][d - 1]
            for r in range(1, 12)) % P for d in range(1, 12)]
    state = new
    for r in range(22):
        s0 = pow(state[0], 7, P)
        if r < 21:
            s0 = (s0 + GK.FAST_PARTIAL_ROUND_CONSTANTS[r]) % P
        d = 25 * s0 + sum(state[i] * GK.FAST_PARTIAL_ROUND_W_HATS[r][i - 1]
                          for i in range(1, 12))
        state = [d % P] + [(s0 * GK.FAST_PARTIAL_ROUND_VS[r][i - 1] + state[i]) % P
                           for i in range(1, 12)]
    rctr += 22
    for _ in range(4):
        state = [(x + rc[12 * rctr + i]) % P for i, x in enumerate(state)]
        state = [pow(x, 7, P) for x in state]
        state = mds(state)
        rctr += 1
    return state


def hash_no_pad(inputs, n_out=4):
    state = [0] * 12
    for i in range(0, len(inputs), 8):
        chunk = inputs[i:i + 8]
        state[:len(chunk)] = [x % P for x in chunk]
        state = poseidon_gl(state)
    return state[:n_out]


class Challenger:
    def __init__(self):
        self.state = [0] * 12
        self.inp = []
        self.out = []

    def observe(self, *elements):
        for e in elements:
            self.out = []
            self.inp.append(int(e) % P)
            if len(self.inp) == 8:
                self._duplex()

    def observe_cap(self, cap):
        for h in cap:
            self.observe(*tovec(h))

    def _duplex(self):
        for i, v in enumerate(self.inp):
            self.state[i] = v
        self.inp = []
        self.state = poseidon_gl(self.state)
        self.out = list(self.state[:8])

    def get(self):
        if self.inp or not self.out:
            self._duplex()
        return self.out.pop()

    def get_qe(self):
        a = self.get()
        b = self.get()
        return (a, b)


# ---------------------------------------------------------------------------
# Poseidon-BN254 (width 4) -- canonical-domain python ints
# ---------------------------------------------------------------------------

def poseidon_bn254(state):
    c, s = BK.C_CONSTANTS, BK.S_CONSTANTS
    m, pm = BK.M_MATRIX, BK.P_MATRIX
    state = [(x + c[i]) % BN_P for i, x in enumerate(state)]

    def exp5(x):
        return pow(x, 5, BN_P)

    def mix(st, mat):
        return [sum(mat[j][i] * st[j] for j in range(4)) % BN_P
                for i in range(4)]

    for i in range(3):
        state = [exp5(x) for x in state]
        state = [(x + c[(i + 1) * 4 + k]) % BN_P for k, x in enumerate(state)]
        state = mix(state, m)
    state = [exp5(x) for x in state]
    state = [(x + c[16 + k]) % BN_P for k, x in enumerate(state)]
    state = mix(state, pm)
    for i in range(56):
        state[0] = (exp5(state[0]) + c[20 + i]) % BN_P
        new0 = sum(s[7 * i + j] * state[j] for j in range(4)) % BN_P
        for k in range(1, 4):
            state[k] = (state[k] + state[0] * s[7 * i + 4 + k - 1]) % BN_P
        state[0] = new0
    for i in range(3):
        state = [exp5(x) for x in state]
        state = [(x + c[76 + i * 4 + k]) % BN_P for k, x in enumerate(state)]
        state = mix(state, m)
    state = [exp5(x) for x in state]
    state = mix(state, m)
    return state


def bn254_hash_no_pad(gl_inputs):
    state = [0, 0, 0, 0]
    for i in range(0, len(gl_inputs), 9):
        chunk = gl_inputs[i:i + 9]
        for slot in range(3):
            part = chunk[slot * 3:slot * 3 + 3]
            if part:
                state[slot + 1] = sum(int(v) << (64 * k)
                                      for k, v in enumerate(part))
        state = poseidon_bn254(state)
    return state[0]


def bn254_two_to_one(left, right):
    return poseidon_bn254([0, 0, left, right])[0]


def tovec(h):
    return [(int(h) >> (56 * i)) & ((1 << 56) - 1) for i in range(5)]


# ---------------------------------------------------------------------------
# Full verification (reference verifier/verifier.go:143-170)
# ---------------------------------------------------------------------------

def verify(spec, raw_proof, raw_vo, query_rounds=None):
    """{"verdict", "plonk_ok", "fri_ok"} of one proof (JSON dicts as
    loaded): ``plonk_ok`` the vanishing check, ``fri_ok`` the proof of work
    and the first ``query_rounds`` FRI query rounds (all by default)."""
    pf = raw_proof["proof"]
    op = pf["openings"]
    opening_proof = pf["opening_proof"]
    pis = [int(x) for x in raw_proof["public_inputs"]]

    pi_hash = hash_no_pad(pis)

    # challenges
    ch = Challenger()
    ch.observe(*tovec(raw_vo["circuit_digest"]))
    ch.observe(*pi_hash)
    ch.observe_cap(pf["wires_cap"])
    betas = [ch.get() for _ in range(spec.num_challenges)]
    gammas = [ch.get() for _ in range(spec.num_challenges)]
    ch.observe_cap(pf["plonk_zs_partial_products_cap"])
    alphas = [ch.get() for _ in range(spec.num_challenges)]
    ch.observe_cap(pf["quotient_polys_cap"])
    zeta = ch.get_qe()
    for key in ["constants", "plonk_sigmas", "wires", "plonk_zs",
                "partial_products", "quotient_polys", "plonk_zs_next"]:
        for pair in op[key]:
            ch.observe(*pair)
    fri_alpha = ch.get_qe()
    fri_betas = []
    for cap in opening_proof["commit_phase_merkle_caps"]:
        ch.observe_cap(cap)
        fri_betas.append(ch.get_qe())
    for pair in opening_proof["final_poly"]["coeffs"]:
        ch.observe(*pair)
    ch.observe(opening_proof["pow_witness"])
    pow_response = ch.get()
    query_indices = [ch.get() for _ in range(spec.num_query_rounds)]

    # ---- plonk vanishing check
    plonk_ok = bool(_check_plonk(spec, op, pi_hash, betas, gammas, alphas,
                                 zeta))

    # ---- pow
    ok = True
    ok &= pow_response < (1 << (64 - spec.pow_bits))

    # ---- FRI
    batch0 = []
    for key in ["constants", "plonk_sigmas", "wires", "plonk_zs",
                "partial_products", "quotient_polys"]:
        batch0 += [(int(a), int(b)) for a, b in op[key]]
    batch1 = [(int(a), int(b)) for a, b in op["plonk_zs_next"]]
    pre0 = reduce_with_powers(batch0, fri_alpha)
    pre1 = reduce_with_powers(batch1, fri_alpha)

    lde_bits = spec.lde_bits
    g_lde = primitive_root_of_unity(lde_bits)
    g_deg = primitive_root_of_unity(spec.degree_bits)
    caps = [raw_vo["constants_sigmas_cap"], pf["wires_cap"],
            pf["plonk_zs_partial_products_cap"], pf["quotient_polys_cap"]]

    rounds = opening_proof["query_round_proofs"][:query_rounds]
    for q, qr in enumerate(rounds):
        x_index = query_indices[q] % (1 << lde_bits)
        bits = [(x_index >> i) & 1 for i in range(lde_bits)]
        cap_index = x_index >> (lde_bits - spec.cap_height)

        # initial tree proofs
        leaves = []
        for o, ep in enumerate(qr["initial_trees_proof"]["evals_proofs"]):
            elems = [int(x) for x in ep[0]]
            leaves.append(elems)
            cur = bn254_hash_no_pad(elems)
            for lvl, sib in enumerate(ep[1]["siblings"]):
                sib = int(sib)
                if bits[lvl]:
                    cur = bn254_two_to_one(sib, cur)
                else:
                    cur = bn254_two_to_one(cur, sib)
            ok &= cur == int(caps[o][cap_index])

        # subgroup x
        rev = int(format(x_index, f"0{lde_bits}b")[::-1], 2)
        subgroup_x = GENERATOR * pow(g_lde, rev, P) % P

        # combine initial
        total = (0, 0)
        evals0 = [(e, 0) for leaf in leaves for e in leaf]
        re0 = reduce_with_powers(evals0, fri_alpha)
        num = qe_sub(re0, pre0)
        den = qe_sub((subgroup_x, 0), zeta)
        total = qe_add(qe_mul(qe_exp(fri_alpha, len(evals0)), total),
                       qe_div(num, den))
        evals1 = [(leaves[2][i], 0) for i in range(spec.num_challenges)]
        re1 = reduce_with_powers(evals1, fri_alpha)
        zeta_next = qe_scalar(zeta, g_deg)
        num = qe_sub(re1, pre1)
        den = qe_sub((subgroup_x, 0), zeta_next)
        total = qe_add(qe_mul(qe_exp(fri_alpha, len(evals1)), total),
                       qe_div(num, den))
        old_eval = total

        for j, arity_bits in enumerate(spec.reduction_arity_bits):
            arity = 1 << arity_bits
            st = qr["steps"][j]
            evals = [(int(a), int(b)) for a, b in st["evals"]]
            within = x_index & (arity - 1)
            coset_index = x_index >> arity_bits
            ok &= evals[within] == old_eval

            old_eval = _compute_eval_ref(subgroup_x, within, arity_bits,
                                         evals, fri_betas[j])

            flat = [x for pair in st["evals"] for x in pair]
            cur = bn254_hash_no_pad([int(x) for x in flat])
            cbits = [(coset_index >> i) & 1
                     for i in range(len(st["merkle_proof"]["siblings"]))]
            for lvl, sib in enumerate(st["merkle_proof"]["siblings"]):
                sib = int(sib)
                if cbits[lvl]:
                    cur = bn254_two_to_one(sib, cur)
                else:
                    cur = bn254_two_to_one(cur, sib)
            ok &= cur == int(
                opening_proof["commit_phase_merkle_caps"][j][cap_index])

            subgroup_x = pow(subgroup_x, arity, P)
            x_index = coset_index

        # final poly
        fp = [(int(a), int(b)) for a, b in opening_proof["final_poly"]["coeffs"]]
        acc = (0, 0)
        for coeff in reversed(fp):
            acc = qe_add(qe_mul(acc, (subgroup_x, 0)), coeff)
        ok &= acc == old_eval

    fri_ok = bool(ok)
    return {"verdict": plonk_ok and fri_ok, "plonk_ok": plonk_ok,
            "fri_ok": fri_ok}


def _compute_eval_ref(x, within, arity_bits, evals, beta):
    arity = 1 << arity_bits
    g = primitive_root_of_unity(arity_bits)
    g_inv = pow(g, arity - 1, P)

    def bitrev(i):
        return int(format(i, f"0{arity_bits}b")[::-1], 2)

    y = [evals[bitrev(i)] for i in range(arity)]
    coset_start = x * pow(g_inv, bitrev(within), P) % P
    xs = [(coset_start * pow(g, i, P) % P, 0) for i in range(arity)]
    # barycentric
    weights = []
    for i in range(arity):
        acc = (1, 0)
        for j in range(arity):
            if i != j:
                acc = qe_mul(acc, qe_sub(xs[i], xs[j]))
        weights.append(qe_inv(acc))
    for i in range(arity):
        if beta == xs[i]:
            return y[i]
    l_x = (1, 0)
    for i in range(arity):
        l_x = qe_mul(l_x, qe_sub(beta, xs[i]))
    ssum = (0, 0)
    for i in range(arity):
        ssum = qe_add(ssum, qe_mul(y[i], qe_mul(weights[i],
                                                qe_inv(qe_sub(beta, xs[i])))))
    return qe_mul(l_x, ssum)


def _check_plonk(spec, op, pi_hash, betas, gammas, alphas, zeta):
    zeta_pow_n = zeta
    for _ in range(spec.degree_bits):
        zeta_pow_n = qe_mul(zeta_pow_n, zeta_pow_n)

    consts = [(int(a), int(b)) for a, b in op["constants"]]
    wires = [(int(a), int(b)) for a, b in op["wires"]]
    zs = [(int(a), int(b)) for a, b in op["plonk_zs"]]
    zs_next = [(int(a), int(b)) for a, b in op["plonk_zs_next"]]
    sigmas = [(int(a), int(b)) for a, b in op["plonk_sigmas"]]
    pps = [(int(a), int(b)) for a, b in op["partial_products"]]
    quots = [(int(a), int(b)) for a, b in op["quotient_polys"]]

    constraint_terms = _eval_gates_ref(spec, consts, wires, pi_hash)

    n = 1 << spec.degree_bits
    l0 = qe_div(qe_sub(zeta_pow_n, (1, 0)),
                qe_sub(qe_scalar(zeta, n), (n % P, 0)))

    z1_terms, pp_terms = [], []
    for i in range(spec.num_challenges):
        z1_terms.append(qe_mul(l0, qe_sub(zs[i], (1, 0))))
        nums, dens = [], []
        for j in range(spec.num_routed_wires):
            s_id = qe_scalar(zeta, spec.k_is[j])
            wpg = qe_add(wires[j], (gammas[i], 0))
            nums.append(qe_add(qe_mul((betas[i], 0), s_id), wpg))
            dens.append(qe_add(qe_mul((betas[i], 0), sigmas[j]), wpg))
        accs = ([zs[i]] + pps[i * spec.num_partial_products:
                              (i + 1) * spec.num_partial_products]
                + [zs_next[i]])
        for k in range(spec.num_partial_products + 1):
            st = k * spec.quotient_degree_factor
            nu, de = (1, 0), (1, 0)
            for j in range(spec.quotient_degree_factor):
                nu = qe_mul(nu, nums[st + j])
                de = qe_mul(de, dens[st + j])
            pp_terms.append(qe_sub(qe_mul(accs[k], nu),
                                   qe_mul(accs[k + 1], de)))

    terms = z1_terms + pp_terms + constraint_terms
    ok = True
    z_h = qe_sub(zeta_pow_n, (1, 0))
    for i in range(spec.num_challenges):
        acc = (0, 0)
        for t in reversed(terms):
            acc = qe_add(t, qe_mul(acc, (alphas[i], 0)))
        chunk = quots[i * spec.quotient_degree_factor:
                      (i + 1) * spec.quotient_degree_factor]
        rhs = qe_mul(z_h, reduce_with_powers(chunk, zeta_pow_n))
        ok &= acc == rhs
    return ok


def _ea_mul(a, b):
    return (qe_add(qe_mul(a[0], b[0]), qe_scalar(qe_mul(a[1], b[1]), W)),
            qe_add(qe_mul(a[0], b[1]), qe_mul(a[1], b[0])))


def _ea_add(a, b):
    return (qe_add(a[0], b[0]), qe_add(a[1], b[1]))


def _ea_sub(a, b):
    return (qe_sub(a[0], b[0]), qe_sub(a[1], b[1]))


def _ea_scalar(s, a):
    return (qe_mul(s, a[0]), qe_mul(s, a[1]))


def _eval_gates_ref(spec, all_consts, wires, pi_hash):
    """Python-int mirror of gates/gates.py (independent implementation for
    cross-checking; per-gate logic cited there)."""
    num_selectors = len(spec.groups)
    consts = all_consts[num_selectors:]
    accum = [(0, 0)] * spec.num_gate_constraints

    def ea(start):
        return (wires[start], wires[start + 1])

    for row, gate in enumerate(spec.gates()):
        sel_idx = spec.selector_indices[row]
        start, end = spec.groups[sel_idx]
        s = all_consts[sel_idx]
        filt = (1, 0)
        for i in range(start, end):
            if i != row:
                filt = qe_mul(filt, qe_sub((i, 0), s))
        if num_selectors > 1:
            filt = qe_mul(filt, qe_sub((UNUSED_SELECTOR, 0), s))

        cons = _eval_one_gate(spec, gate, consts, wires, pi_hash, ea)
        for k, c in enumerate(cons):
            accum[k] = qe_add(accum[k], qe_mul(c, filt))
    return accum


def _eval_one_gate(spec, gate, consts, wires, pi_hash, ea):
    if isinstance(gate, NoopGate):
        return []
    if isinstance(gate, ConstantGate):
        return [qe_sub(consts[i], wires[i]) for i in range(gate.num_consts)]
    if isinstance(gate, PublicInputGate):
        return [qe_sub(wires[i], (pi_hash[i], 0)) for i in range(4)]
    if isinstance(gate, ArithmeticGate):
        out = []
        for i in range(gate.num_ops):
            computed = qe_add(qe_mul(qe_mul(wires[4 * i], wires[4 * i + 1]),
                                     consts[0]),
                              qe_mul(wires[4 * i + 2], consts[1]))
            out.append(qe_sub(wires[4 * i + 3], computed))
        return out
    if isinstance(gate, ArithmeticExtensionGate):
        out = []
        for i in range(gate.num_ops):
            m0, m1 = ea(8 * i), ea(8 * i + 2)
            ad, o = ea(8 * i + 4), ea(8 * i + 6)
            comp = _ea_add(_ea_scalar(consts[1], ad),
                           _ea_scalar(consts[0], _ea_mul(m0, m1)))
            d = _ea_sub(o, comp)
            out += [d[0], d[1]]
        return out
    if isinstance(gate, MulExtensionGate):
        out = []
        for i in range(gate.num_ops):
            m0, m1, o = ea(6 * i), ea(6 * i + 2), ea(6 * i + 4)
            d = _ea_sub(o, _ea_scalar(consts[0], _ea_mul(m0, m1)))
            out += [d[0], d[1]]
        return out
    if isinstance(gate, BaseSumGate):
        total = wires[0]
        limbs = [wires[1 + i] for i in range(gate.num_limbs)]
        computed = reduce_with_powers(limbs, (gate.base, 0))
        out = [qe_sub(computed, total)]
        for limb in limbs:
            acc = (1, 0)
            for i in range(gate.base):
                acc = qe_mul(acc, qe_sub(limb, (i, 0)))
            out.append(acc)
        return out
    if isinstance(gate, ExponentiationGate):
        npb = gate.num_power_bits
        base = wires[0]
        bits = [wires[1 + i] for i in range(npb)]
        output = wires[1 + npb]
        inters = [wires[2 + npb + i] for i in range(npb)]
        out = []
        for i in range(npb):
            prev = (1, 0) if i == 0 else qe_mul(inters[i - 1], inters[i - 1])
            cur = bits[npb - i - 1]
            mul_by = qe_sub(qe_mul(cur, base), qe_sub(cur, (1, 0)))
            out.append(qe_sub(qe_mul(prev, mul_by), inters[i]))
        out.append(qe_sub(output, inters[npb - 1]))
        return out
    if isinstance(gate, RandomAccessGate):
        out = []
        stride = 2 + gate.vec_size
        num_routed = stride * gate.num_copies + gate.num_extra_constants
        for copy in range(gate.num_copies):
            idx = wires[stride * copy]
            claimed = wires[stride * copy + 1]
            items = [wires[stride * copy + 2 + i] for i in range(gate.vec_size)]
            bits = [wires[num_routed + copy * gate.bits + i]
                    for i in range(gate.bits)]
            for b in bits:
                out.append(qe_sub(qe_mul(b, b), b))
            out.append(qe_sub(reduce_with_powers(bits, (2, 0)), idx))
            for b in bits:
                items = [qe_add(items[i], qe_mul(b, qe_sub(items[i + 1],
                                                           items[i])))
                         for i in range(0, len(items), 2)]
            out.append(qe_sub(items[0], claimed))
        for i in range(gate.num_extra_constants):
            out.append(qe_sub(consts[i], wires[stride * gate.num_copies + i]))
        return out
    if isinstance(gate, ReducingGate):
        alpha, acc = ea(2), ea(4)
        start_accs = 6 + gate.num_coeffs
        out = []
        for i in range(gate.num_coeffs):
            acc_i = ea(0) if i == gate.num_coeffs - 1 else ea(start_accs + 2 * i)
            coeff = (wires[6 + i], (0, 0))
            t = _ea_sub(_ea_add(_ea_mul(acc, alpha), coeff), acc_i)
            out += [t[0], t[1]]
            acc = acc_i
        return out
    if isinstance(gate, ReducingExtensionGate):
        alpha, acc = ea(2), ea(4)
        start_accs = 6 + gate.num_coeffs * 2
        out = []
        for i in range(gate.num_coeffs):
            acc_i = ea(0) if i == gate.num_coeffs - 1 else ea(start_accs + 2 * i)
            coeff = ea(6 + 2 * i)
            t = _ea_sub(_ea_add(_ea_mul(acc, alpha), coeff), acc_i)
            out += [t[0], t[1]]
            acc = acc_i
        return out
    if isinstance(gate, PoseidonMdsGate):
        out = []
        inputs = [ea(i * 2) for i in range(12)]
        for r in range(12):
            acc = ((0, 0), (0, 0))
            for i in range(12):
                acc = _ea_add(acc, _ea_scalar((GK.MDS_MATRIX_CIRC[i], 0),
                                              inputs[(i + r) % 12]))
            if GK.MDS_MATRIX_DIAG[r]:
                acc = _ea_add(acc, _ea_scalar((GK.MDS_MATRIX_DIAG[r], 0),
                                              inputs[r]))
            d = _ea_sub(ea((12 + r) * 2), acc)
            out += [d[0], d[1]]
        return out
    if isinstance(gate, CosetInterpolationGate):
        return _coset_gate_ref(gate, consts, wires, ea)
    if isinstance(gate, PoseidonGate):
        return _poseidon_gate_ref(gate, consts, wires)
    raise NotImplementedError(type(gate))


def _coset_gate_ref(gate, consts, wires, ea):
    n = gate.num_points
    start_eval_point = 1 + n * 2
    start_eval_value = start_eval_point + 2
    start_inter = start_eval_value + 2
    shift = wires[0]
    eval_point = ea(start_eval_point)
    shifted = ea(start_inter + 2 * 2 * gate.num_intermediates)
    out = []
    neg_shift = qe_scalar(shift, P - 1)
    tmp = _ea_add(_ea_scalar(neg_shift, shifted), eval_point)
    out += [tmp[0], tmp[1]]

    domain = []
    g = primitive_root_of_unity(gate.subgroup_bits)
    v = 1
    for _ in range(n):
        domain.append(v)
        v = v * g % P
    values = [ea(1 + 2 * i) for i in range(n)]

    def partial(dom, vals, ws, point, ev, pr):
        for x, val, w in zip(dom, vals, ws):
            term = _ea_sub(point, ((x, 0), (0, 0)))
            wv = (qe_scalar(val[0], w), qe_scalar(val[1], w))
            ev = _ea_add(_ea_mul(ev, term), _ea_mul(wv, pr))
            pr = _ea_mul(pr, term)
        return ev, pr

    ce, cp = partial(domain[:gate.degree], values[:gate.degree],
                     gate.weights[:gate.degree], shifted,
                     ((0, 0), (0, 0)), ((1, 0), (0, 0)))
    for i in range(gate.num_intermediates):
        ie = ea(start_inter + 2 * i)
        ip = ea(start_inter + 2 * (gate.num_intermediates + i))
        d = _ea_sub(ie, ce)
        out += [d[0], d[1]]
        d = _ea_sub(ip, cp)
        out += [d[0], d[1]]
        si = 1 + (gate.degree - 1) * (i + 1)
        ei = min(si + gate.degree - 1, n)
        ce, cp = partial(domain[si:ei], values[si:ei], gate.weights[si:ei],
                         shifted, ie, ip)
    d = _ea_sub(ea(start_eval_value), ce)
    out += [d[0], d[1]]
    return out


def _poseidon_gate_ref(gate, consts, wires):
    out = []
    swap = wires[gate.w_swap]
    out.append(qe_mul(swap, qe_sub(swap, (1, 0))))
    for i in range(4):
        lhs, rhs = wires[i], wires[i + 4]
        delta = wires[gate.w_delta(i)]
        out.append(qe_sub(qe_mul(swap, qe_sub(rhs, lhs)), delta))
    state = [None] * 12
    for i in range(4):
        delta = wires[gate.w_delta(i)]
        state[i] = qe_add(wires[i], delta)
        state[i + 4] = qe_sub(wires[i + 4], delta)
    for i in range(8, 12):
        state[i] = wires[i]

    def sbox(x):
        x2 = qe_mul(x, x)
        return qe_mul(qe_mul(x2, x2), qe_mul(x, x2))

    def mds(st):
        o = []
        for r in range(12):
            acc = (0, 0)
            for i in range(12):
                acc = qe_add(acc, qe_scalar(st[(i + r) % 12],
                                            GK.MDS_MATRIX_CIRC[i]))
            acc = qe_add(acc, qe_scalar(st[r], GK.MDS_MATRIX_DIAG[r]))
            o.append(acc)
        return o

    rctr = 0
    for r in range(4):
        state = [qe_add(state[i], (GK.ALL_ROUND_CONSTANTS[i + 12 * rctr], 0))
                 for i in range(12)]
        if r != 0:
            for i in range(12):
                sb = wires[gate.w_full0(r, i)]
                out.append(qe_sub(state[i], sb))
                state[i] = sb
        state = [sbox(x) for x in state]
        state = mds(state)
        rctr += 1

    state = [qe_add(state[i], (GK.FAST_PARTIAL_FIRST_ROUND_CONSTANT[i], 0))
             for i in range(12)]
    new = [state[0]]
    for d in range(1, 12):
        acc = (0, 0)
        for r in range(1, 12):
            acc = qe_add(acc, qe_scalar(
                state[r], GK.FAST_PARTIAL_ROUND_INITIAL_MATRIX[r - 1][d - 1]))
        new.append(acc)
    state = new
    for r in range(22):
        sb = wires[gate.w_partial(r)]
        out.append(qe_sub(state[0], sb))
        state[0] = sbox(sb)
        if r < 21:
            state[0] = qe_add(state[0], (GK.FAST_PARTIAL_ROUND_CONSTANTS[r], 0))
        d = qe_scalar(state[0], 25)
        for i in range(1, 12):
            d = qe_add(d, qe_scalar(state[i],
                                    GK.FAST_PARTIAL_ROUND_W_HATS[r][i - 1]))
        state = [d] + [qe_add(qe_scalar(state[0],
                                        GK.FAST_PARTIAL_ROUND_VS[r][i - 1]),
                              state[i]) for i in range(1, 12)]
    rctr += 22
    for r in range(4):
        state = [qe_add(state[i], (GK.ALL_ROUND_CONSTANTS[i + 12 * rctr], 0))
                 for i in range(12)]
        for i in range(12):
            sb = wires[gate.w_full1(r, i)]
            out.append(qe_sub(state[i], sb))
            state[i] = sb
        state = [sbox(x) for x in state]
        state = mds(state)
        rctr += 1
    for i in range(12):
        out.append(qe_sub(state[i], wires[12 + i]))
    return out
