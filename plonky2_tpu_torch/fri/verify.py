"""FRI opening-proof verification, batched over (proof, query round).

Counterpart of ``plonky2_tpu/fri/verify.py``.  Every check is a verdict-bit
conjunction, so an invalid proof yields False without aborting the batch.
Per-query quantities are shaped (B, Q).  Every Merkle leaf hash and
sibling path of a verification is one chain of Poseidon-BN254 permutations,
and all of them run in one call (``fri/merkle.merkle_roots``: one launch of
a chain kernel on the GPU), on absorb blocks built from the batch's leaves
(``fri/merkle.leaf_blocks``: one launch of the block builder on the
GPU).  ``_hash_leaves_scan`` and ``_merkle_chain`` keep the JAX package's
two scans, one permutation call a step, as the pieces the tests hold the
chains against.  Digests are compared in the Montgomery domain.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import goldilocks as gl
from ..fields import goldilocks_ext as qe
from ..fields import bn254
from ..hash import poseidon_bn254 as pb
from . import merkle


def _bits_to_index(bits):
    idx = torch.zeros_like(bits[0])
    for i, b in enumerate(bits):
        idx = idx | (b << i)
    return idx


def _pow_ok(pr, pow_bits):
    """The pow response must fit in 64 - pow_bits bits; pr is a GL pair."""
    max_bits = 64 - pow_bits
    if max_bits < 32:
        return (pr[1] == 0) & (pr[0] < (1 << max_bits))
    if max_bits == 32:
        return pr[1] == 0
    if max_bits < 64:
        return pr[1] < (1 << (max_bits - 32))
    return torch.ones_like(pr[0], dtype=torch.bool)


def _merkle_chain(digest, siblings, index_bits, depth):
    """Walk Merkle paths: digest (..., 16); siblings (..., depth, 16);
    index_bits[i] (...,) 0/1 picks the side at level i."""
    cur = digest
    z = torch.zeros_like(digest)
    for lvl in range(depth):
        sib = siblings[..., lvl, :]
        m = index_bits[lvl].bool()[..., None]
        left = torch.where(m, sib, cur)
        right = torch.where(m, cur, sib)
        cur = pb.permute(torch.stack([z, z, left, right], dim=-2))[..., 0, :]
    return cur


def _cap_lookup(cap, cap_index):
    """cap: (B, cap_size, 16); cap_index: (B, ...) -> (B, ..., 16)."""
    B = cap.shape[0]
    flat = cap_index.reshape(B, -1)
    rows = torch.arange(B, device=cap.device)[:, None]
    return cap[rows, flat].reshape(cap_index.shape + (16,))


def _hash_leaves_scan(packed, slot_mask):
    """Batched HashNoPad over precomputed absorb blocks.

    packed: (..., T, 3, 16) Montgomery blocks; slot_mask: (T, 3) bool.
    Slot 0 is kept and only the masked slots 1..3 are overwritten."""
    T = packed.shape[-3]
    state = torch.zeros(packed.shape[:-3] + (4, 16), dtype=packed.dtype,
                        device=packed.device)
    smask = gl.device_table(slot_mask, packed.device)
    for t in range(T):
        rest = torch.where(smask[t][:, None], packed[..., t, :, :],
                           state[..., 1:, :])
        state = pb.permute(torch.cat([state[..., :1, :], rest], dim=-2))
    return state[..., 0, :]


def _dot_base_with_alpha(evals, apows):
    """sum_i evals_i * alpha^i: base-field evals (B, Q, L), QE powers (B, L)
    -> QE (B, Q)."""
    p0 = (apows[0][0][:, None, :], apows[0][1][:, None, :])
    p1 = (apows[1][0][:, None, :], apows[1][1][:, None, :])
    d0 = gl.sum_digits_axis(gl.mul_digits(evals, p0), -1)
    d1 = gl.sum_digits_axis(gl.mul_digits(evals, p1), -1)
    return (gl.reduce_digits(d0), gl.reduce_digits(d1))


def _bcast_qe(x):
    """QE (B,) -> QE (B, 1)."""
    return qe.index(x, (Ellipsis, None))


def query_rounds(spec, query_shard=None):
    """The FRI query rounds ``[start, stop)`` a batch holds: all of them, or
    with ``query_shard=(k, n)`` the k-th of n contiguous blocks of Q/n, the
    rounds that a JAX ("proof", "query") mesh gives query shard k."""
    Q = spec.num_query_rounds
    if query_shard is None:
        return 0, Q
    k, n = query_shard
    if n < 1 or Q % n or not 0 <= k < n:
        raise ValueError(f"query shard {k} of {n}: the {Q} query rounds of "
                         f"the circuit must split into n equal blocks")
    return k * Q // n, (k + 1) * Q // n


def check_query_rounds(spec, dev, query_shard=None):
    """Raise ValueError unless the tensor dict ``dev`` holds the query rounds
    of ``query_rounds(spec, query_shard)``; returns their (start, stop).  The
    JAX package takes Q from the data; here a batch with another count is
    malformed, not a proof to judge."""
    start, stop = query_rounds(spec, query_shard)
    Q = dev["init_siblings"].shape[1]
    if Q != stop - start:
        raise ValueError(f"batch has {Q} FRI query rounds, expected "
                         f"{stop - start} of the circuit's "
                         f"{spec.num_query_rounds} (query shard {query_shard})")
    return start, stop


def verify_fri(spec, dev, challenges, verdict, query_shard=None):
    """Verify the FRI opening proof; returns the updated (B,) verdict.

    With ``query_shard=(k, n)``, ``dev`` holds only the query rounds of
    ``query_rounds(spec, query_shard)`` and only those rounds are checked;
    the verdict is then this shard's share, to be ANDed over the n shards."""
    start, stop = check_query_rounds(spec, dev, query_shard)
    if query_shard is not None:
        challenges = dict(challenges, query_indices=tuple(
            t[:, start:stop] for t in challenges["query_indices"]))
    lde_bits = spec.lde_bits

    verdict = verdict & _pow_ok(challenges["pow_response"], spec.pow_bits)

    # --- precomputed reduced openings
    alpha = challenges["fri_alpha"]
    batch0 = qe.concat([dev[key] for key in
                        ["op_constants", "op_plonk_sigmas", "op_wires",
                         "op_plonk_zs", "op_partial_products",
                         "op_quotient_polys"]])           # QE (B, n0)
    batch1 = dev["op_plonk_zs_next"]                      # QE (B, nc)
    pre0 = qe.horner(batch0, alpha)
    pre1 = qe.horner(batch1, alpha)

    # --- per-round index bits
    x_index = challenges["query_indices"]                 # GL pair (B, Q)
    bits = gl.to_bits(x_index, 64)[:lde_bits]
    cap_bits = bits[lde_bits - spec.cap_height:]
    if cap_bits:
        cap_index = _bits_to_index(cap_bits)
    else:
        cap_index = torch.zeros_like(x_index[0])

    # --- every leaf hash and Merkle path: roots (B, Q, 4 + steps, 16),
    # the initial oracles' then each reduction step's, from absorb blocks
    # built of the leaves that the checks below read
    blocks = merkle.leaf_blocks(spec, dev)
    roots = merkle.merkle_roots(merkle.merkle_plan(spec), {**dev, **blocks},
                                x_index)

    # --- initial tree Merkle proofs
    caps = torch.stack([dev["const_sigmas_cap"], dev["wires_cap"],
                        dev["zs_pp_cap"], dev["quotient_cap"]], dim=1)
    for o in range(4):
        expected = _cap_lookup(caps[:, o], cap_index)
        verdict = verdict & torch.all(bn254.eq(roots[..., o, :], expected), dim=-1)

    # --- subgroup_x = GENERATOR * root^bitrev(idx), one launch
    subgroup_x = gl.mul_const_bits(
        None, gl.MULTIPLICATIVE_GROUP_GENERATOR, x_index, 0,
        gl.bitrev_powers(gl.primitive_root_of_unity(lde_bits), lde_bits))

    # --- combine initial
    zeta = challenges["zeta"]
    n0 = batch0[0][0].shape[-1]
    apow0 = qe.powers(alpha, n0)                          # QE (B, n0)
    evals0 = gl.concat([dev[f"init_leaves_{o}"] for o in range(4)])  # (B,Q,L)
    re0 = _dot_base_with_alpha(evals0, apow0)
    sx_qe = qe.from_base(subgroup_x)

    num0 = qe.sub(re0, _bcast_qe(pre0))
    den0 = qe.sub(sx_qe, _bcast_qe(zeta))
    verdict = verdict & torch.all(~qe.is_zero(den0), dim=-1)
    total = qe.mul(num0, qe.inv(den0))

    # batch 1: Zs at g*zeta (the first num_challenges leaf-2 elements)
    g_deg = gl.primitive_root_of_unity(spec.degree_bits)
    zeta_next = (gl.mul_const(zeta[0], g_deg), gl.mul_const(zeta[1], g_deg))
    nb1 = spec.num_challenges
    evals1 = gl.index(dev["init_leaves_2"], (Ellipsis, slice(0, nb1)))
    re1 = _dot_base_with_alpha(evals1, qe.powers(alpha, nb1))
    num1 = qe.sub(re1, _bcast_qe(pre1))
    den1 = qe.sub(sx_qe, _bcast_qe(zeta_next))
    verdict = verdict & torch.all(~qe.is_zero(den1), dim=-1)
    a_n = alpha
    for _ in range(nb1 - 1):
        a_n = qe.mul(a_n, alpha)
    old_eval = qe.add(qe.mul(_bcast_qe(a_n), total), qe.mul(num1, qe.inv(den1)))

    # --- reduction steps; round j's coset starts at bit ``off`` of x_index
    off = 0
    for j, arity_bits in enumerate(spec.reduction_arity_bits):
        within_bits = bits[:arity_bits]
        coset_bits = bits[arity_bits:]
        within_idx = _bits_to_index(within_bits)          # (B, Q)

        evals = dev[f"step{j}_evals"]                     # QE (B, Q, 2^bits)
        # the eval at within_idx must equal the previous round's eval
        sel = tuple(tuple(torch.gather(c, -1, within_idx[..., None])[..., 0]
                          for c in comp) for comp in evals)
        verdict = verdict & torch.all(qe.eq(sel, old_eval), dim=-1)

        old_eval = _compute_evaluation(subgroup_x, x_index, off, arity_bits,
                                       evals, challenges["fri_betas"][j])

        # Merkle check of the step evals against commit cap j
        expected = _cap_lookup(dev["commit_caps"][:, j], cap_index)
        verdict = verdict & torch.all(bn254.eq(roots[..., 4 + j, :], expected),
                                      dim=-1)

        for _ in range(arity_bits):
            subgroup_x = gl.mul(subgroup_x, subgroup_x)
        bits = coset_bits
        off += arity_bits

    # --- final polynomial check
    fp_b = qe.index(dev["final_poly"], (Ellipsis, None, slice(None)))  # (B,1,F)
    acc = qe.horner(fp_b, qe.from_base(subgroup_x))       # (B, Q)
    return verdict & torch.all(qe.eq(old_eval, acc), dim=-1)


def _compute_evaluation(x, x_index, off, arity_bits, evals, beta):
    """Barycentric interpolation of the coset evals at beta, stacked over the
    coset axis, with the fallback for beta on a coset point.  The coset's
    index within the round is bits off .. off + arity_bits - 1 of
    x_index."""
    arity = 1 << arity_bits
    g = gl.primitive_root_of_unity(arity_bits)
    g_inv = pow(g, arity - 1, gl.P)
    device = x[0].device

    def bitrev(i):
        return int(f"{i:0{arity_bits}b}"[::-1], 2)

    perm = np.asarray([bitrev(i) for i in range(arity)])
    inv_perm = np.zeros(arity, dtype=np.int64)
    inv_perm[perm] = np.arange(arity)
    y_st = qe.index(evals, (Ellipsis, gl.device_table(inv_perm, device)))

    # cosetStart = x * gInv^bitrev(within_idx), one launch
    coset_start = gl.mul_const_bits(x, 1, x_index, off,
                                    gl.bitrev_powers(g_inv, arity_bits))

    g_pows = gl.const_array([pow(g, i, gl.P) for i in range(arity)])
    cs_b = qe.index(qe.from_base(coset_start), (Ellipsis, None))   # (B, Q, 1)
    x_st = qe.mul_const_arr(cs_b, g_pows)                 # (B, Q, arity)

    # barycentric weights w_i = 1 / prod_{j != i} (x_i - x_j)
    xi = qe.index(x_st, (Ellipsis, slice(None), None))    # (B, Q, A, 1)
    xj = qe.index(x_st, (Ellipsis, None, slice(None)))    # (B, Q, 1, A)
    pd = qe.sub(xi, xj)                                   # (B, Q, A, A)
    eye = torch.eye(arity, dtype=torch.bool, device=device)
    pd = qe.select(eye, qe.ones_like(pd), pd)
    w_inv = qe.inv(qe.prod_axis(pd))                      # (B, Q, A)

    beta_b = qe.index(beta, (Ellipsis, None, None))       # (B, 1, 1)
    diff = qe.sub(beta_b, x_st)                           # (B, Q, arity)
    any_zero = qe.is_zero(diff)

    l_x = qe.prod_axis(diff)
    terms = qe.mul(y_st, qe.mul(w_inv, qe.inv(diff)))
    interpolation = qe.mul(l_x, qe.sum_axis(terms))

    hit = torch.any(any_zero, dim=-1)
    picked = qe.select(any_zero, y_st, qe.zeros_like(y_st))
    return qe.select(hit, qe.sum_axis(picked), interpolation)
