"""Synthetic tiny circuit spec and shape-correct dummy proofs.

Counterpart of ``plonky2_tpu/proof/synthetic.py``: the same spec, field by
field, and the same numpy proof dicts, array by array, built from this
package's own field and serde helpers.  The mesh and distributed tests and
``tools/scaling_bench.py --tiny`` use them to drive the whole verification
path (transcript, Poseidon-GL/BN254, Merkle scans, FRI folds, PLONK
vanishing) at the smallest shape.  A dummy proof is structurally valid
(shapes, canonical values) but cryptographically meaningless, so it verifies
as False.
"""

from __future__ import annotations

import numpy as np

from .spec import CircuitSpec
from . import serde as _serde
from ..fields import bn254


def make_tiny_spec(num_query_rounds=1):
    """Smallest internally-consistent spec: 1 challenge, 1 query round
    (overridable, e.g. for query-axis sharding tests), cap height 0,
    arity 2.  Oracles 2 and 3 (Zs+partial products, quotient) have 2 leaf
    elements each, so the HashOrNoop path (reference poseidon/bn254.go:79-94)
    runs on every dummy proof."""
    return CircuitSpec(
        num_wires=8,
        num_routed_wires=4,
        num_constants_cfg=2,
        security_bits=100,
        num_challenges=1,
        rate_bits=3,
        cap_height=0,
        pow_bits=0,
        num_query_rounds=num_query_rounds,
        degree_bits=2,
        reduction_arity_bits=(1,),
        gate_ids=("NoopGate",
                  "ArithmeticGate { num_ops: 2 }",
                  "PublicInputGate"),
        selector_indices=(0, 0, 0),
        groups=((0, 3),),
        quotient_degree_factor=2,
        num_gate_constraints=4,
        num_constants=3,
        num_public_inputs=4,
        k_is=tuple(range(1, 5)),
        num_partial_products=1,
    )


def make_dummy_proof(spec, seed=0):
    """Shape-correct low-entropy proof dict (single proof, unbatched)."""
    rng = np.random.default_rng(seed)

    def glv(*shape):
        if not shape:
            return np.uint64(rng.integers(0, 1 << 30))
        return rng.integers(0, 1 << 30, size=shape).astype(np.uint64)

    Q = spec.num_query_rounds
    cs = spec.cap_size
    nsteps = len(spec.reduction_arity_bits)
    out = {
        "public_inputs": glv(spec.num_public_inputs),
        "op_constants": glv(spec.num_constants, 2),
        "op_plonk_sigmas": glv(spec.num_routed_wires, 2),
        "op_wires": glv(spec.num_wires, 2),
        "op_plonk_zs": glv(spec.num_challenges, 2),
        "op_plonk_zs_next": glv(spec.num_challenges, 2),
        "op_partial_products": glv(spec.num_challenges * spec.num_partial_products, 2),
        "op_quotient_polys": glv(spec.num_quotient_polys, 2),
        "final_poly": glv(spec.final_poly_len, 2),
        "pow_witness": glv(),
    }

    def digest(x):
        return np.asarray(bn254.int_to_mont_limbs(x), dtype=np.uint32)

    def tovec(x):
        return np.asarray([(x >> (56 * i)) & ((1 << 56) - 1)
                           for i in range(_serde.TOVEC_CHUNKS)], dtype=np.uint64)

    for name in ["wires_cap", "zs_pp_cap", "quotient_cap"]:
        vals = [int(rng.integers(1, 1 << 60)) for _ in range(cs)]
        out[name] = np.stack([digest(v) for v in vals])
        out[f"{name}_tovec"] = np.stack([tovec(v) for v in vals])
    out["const_sigmas_cap"] = np.stack([digest(7)] * cs)
    out["circuit_digest"] = digest(11)
    out["circuit_digest_tovec"] = tovec(11)
    cap_vals = [[int(rng.integers(1, 1 << 60)) for _ in range(cs)]
                for _ in range(nsteps)]
    out["commit_caps"] = np.stack(
        [np.stack([digest(v) for v in cv]) for cv in cap_vals])
    out["commit_caps_tovec"] = np.stack(
        [np.stack([tovec(v) for v in cv]) for cv in cap_vals])

    layout = _serde.leaf_layout(spec)
    sizes = spec.oracle_leaf_sizes
    depth = spec.initial_tree_depth
    init_packed = np.zeros((Q, 4, layout.max_steps, 3, 16), dtype=np.uint32)
    for o in range(4):
        leaf = glv(Q, sizes[o])
        out[f"init_leaves_{o}"] = leaf
        for q in range(Q):
            for t, (block, _) in enumerate(
                    _serde._pack_leaf_mont([int(x) for x in leaf[q]])):
                init_packed[q, o, t] = block
    out["init_leaf_packed"] = init_packed
    out["init_siblings"] = np.zeros((Q, 4, depth, 16), dtype=np.uint32)

    for j, a in enumerate(spec.reduction_arity_bits):
        ev = glv(Q, 1 << a, 2)
        out[f"step{j}_evals"] = ev
        n_chunks = _serde.absorb_slot_masks((1 << a) * 2).shape[0]
        pk = np.zeros((Q, n_chunks, 3, 16), dtype=np.uint32)
        for q in range(Q):
            flat = [int(x) for pair in ev[q] for x in pair]
            for t, (block, _) in enumerate(_serde._pack_leaf_mont(flat)):
                pk[q, t] = block
        out[f"step{j}_leaf_packed"] = pk
        out[f"step{j}_siblings"] = np.zeros(
            (Q, spec.step_tree_depths[j], 16), dtype=np.uint32)
    return out
