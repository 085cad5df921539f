"""PLONK vanishing-polynomial check at zeta.

Counterpart of ``plonky2_tpu/plonk_checks/vanishing.py`` (``verify_plonk``).
Evaluates the gate constraints, the Z(zeta) boundary term and the permutation
argument's partial-product checks, combines them with the alpha challenges,
and checks against Z_H(zeta) * t(zeta) -- batched QE arithmetic that turns
each check into a verdict bit instead of an exception.
"""

from __future__ import annotations

import torch

from ..fields import goldilocks as gl
from ..fields import goldilocks_ext as qe
from ..gates.gates import evaluate_gate_constraints


def verify_plonk(spec, dev, challenges, pi_hash, verdict):
    """dev's op_* entries are QE arrays of shape (B, n)."""
    zeta = challenges["zeta"]
    like = zeta[0][0]
    B = like.shape[0]
    device = like.device

    zeta_pow_n = zeta
    for _ in range(spec.degree_bits):
        zeta_pow_n = qe.square(zeta_pow_n)

    local_constants = dev["op_constants"]
    local_wires = dev["op_wires"]
    zs = dev["op_plonk_zs"]
    zs_next = dev["op_plonk_zs_next"]
    sigmas = dev["op_plonk_sigmas"]
    partial_products = dev["op_partial_products"]
    quotient_polys = dev["op_quotient_polys"]

    constraint_terms = evaluate_gate_constraints(
        spec.gates(), spec.selector_indices, spec.groups,
        spec.num_gate_constraints, local_constants, local_wires, pi_hash)

    # L_0(zeta) = (zeta^n - 1) / (n * (zeta - 1))
    n_const = 1 << spec.degree_bits
    one = qe.ones((B,), device)
    numerator = qe.sub(zeta_pow_n, one)
    denominator = qe.sub(qe.scalar_mul_const(zeta, n_const),
                         qe.from_ints(n_const, 0, (B,), device))
    verdict = verdict & ~qe.is_zero(denominator)
    l0_zeta = qe.mul(numerator, qe.inv(denominator))

    nc = spec.num_challenges
    qdf = spec.quotient_degree_factor
    npp = spec.num_partial_products
    R = spec.num_routed_wires
    wires_r = qe.index(local_wires, (Ellipsis, slice(0, R)))
    k_arr = gl.const_array(list(spec.k_is))

    def col(x):
        return qe.index(x, (Ellipsis, None))

    z1_terms = []
    pp_terms = []
    for i in range(nc):
        beta = col(qe.from_base(challenges["plonk_betas"][i]))
        gamma = col(qe.from_base(challenges["plonk_gammas"][i]))
        z_i = qe.index(zs, (Ellipsis, i))
        z1_terms.append(qe.mul(l0_zeta, qe.sub(z_i, one)))

        # s_id_j = k_j * zeta; numer_j = beta*s_id_j + wire_j + gamma
        s_id = qe.mul_const_arr(col(zeta), k_arr)            # (B, R)
        wire_plus_gamma = qe.add(wires_r, gamma)
        numerators = qe.add(qe.mul(beta, s_id), wire_plus_gamma)
        denominators = qe.add(qe.mul(beta, sigmas), wire_plus_gamma)

        num_prod = qe.prod_axis(qe.reshape(numerators, (B, npp + 1, qdf)))
        den_prod = qe.prod_axis(qe.reshape(denominators, (B, npp + 1, qdf)))

        pps = qe.index(partial_products,
                       (Ellipsis, slice(i * npp, (i + 1) * npp)))
        accs = qe.concat([col(z_i), pps, col(qe.index(zs_next, (Ellipsis, i)))])
        lhs = qe.mul(qe.index(accs, (Ellipsis, slice(0, npp + 1))), num_prod)
        rhs = qe.mul(qe.index(accs, (Ellipsis, slice(1, None))), den_prod)
        pp_terms.append(qe.sub(lhs, rhs))                    # (B, npp+1)

    vanishing_terms = qe.concat(
        [qe.stack(z1_terms, axis=-1)] + pp_terms + [constraint_terms])

    # alpha-combine per challenge: sum_i terms[i] * alpha^i
    reduced = [qe.horner(vanishing_terms,
                         qe.from_base(challenges["plonk_alphas"][i]))
               for i in range(nc)]

    # vanishing[i] == Z_H(zeta) * reduce(quotient chunk i, zeta^n)
    z_h_zeta = qe.sub(zeta_pow_n, one)
    chunks = qe.reshape(quotient_polys, (B, nc, qdf))
    combined = qe.horner(chunks, col(zeta_pow_n))            # (B, nc)
    rhs = qe.mul(col(z_h_zeta), combined)
    lhs = qe.stack(reduced, axis=-1)                         # (B, nc)
    return verdict & torch.all(qe.eq(lhs, rhs), dim=-1)
