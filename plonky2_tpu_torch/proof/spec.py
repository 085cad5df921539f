"""Circuit specification: static shape/constant data for one plonky2 circuit.

Counterpart of ``plonky2_tpu/proof/spec.py``; gate IDs are parsed by the
port's own (jax-free) registry in ``gates/gates.py``.

Ingests the same ``common_circuit_data.json`` format the reference consumes
(reference types/common_data.go:61-127), including plonky2's Rust
Debug-string gate IDs.  Everything here is static for the verifier:
shapes, gate list, selector groups, FRI layout.
"""

from __future__ import annotations

import dataclasses
import json

from ..gates.gates import gate_from_id


@dataclasses.dataclass(frozen=True)
class CircuitSpec:
    # config (reference types/types.go:62-72)
    num_wires: int
    num_routed_wires: int
    num_constants_cfg: int
    security_bits: int
    num_challenges: int
    # fri config (reference types/types.go:7-15)
    rate_bits: int
    cap_height: int
    pow_bits: int
    num_query_rounds: int
    # fri params / common data (reference types/types.go:21-86)
    degree_bits: int
    reduction_arity_bits: tuple
    gate_ids: tuple
    selector_indices: tuple
    groups: tuple  # ((start, end), ...)
    quotient_degree_factor: int
    num_gate_constraints: int
    num_constants: int
    num_public_inputs: int
    k_is: tuple
    num_partial_products: int

    # ---- derived quantities (reference types/types.go:28-60, fri/fri_utils.go)
    @property
    def lde_bits(self):
        return self.degree_bits + self.rate_bits

    @property
    def cap_size(self):
        return 1 << self.cap_height

    @property
    def final_poly_len(self):
        return 1 << (self.degree_bits - sum(self.reduction_arity_bits))

    @property
    def num_preprocessed_polys(self):
        # constants then sigmas in oracle 0 (reference fri/fri_utils.go:60-72)
        return self.num_constants + self.num_routed_wires

    @property
    def num_zs_partial_products_polys(self):
        return self.num_challenges * (1 + self.num_partial_products)

    @property
    def num_quotient_polys(self):
        return self.num_challenges * self.quotient_degree_factor

    @property
    def oracle_leaf_sizes(self):
        """Per-oracle number of leaf elements (reference fri/fri_utils.go:123-142)."""
        return (self.num_preprocessed_polys, self.num_wires,
                self.num_zs_partial_products_polys, self.num_quotient_polys)

    @property
    def initial_tree_depth(self):
        return self.lde_bits - self.cap_height

    @property
    def step_tree_depths(self):
        depths = []
        bits = self.lde_bits
        for a in self.reduction_arity_bits:
            bits -= a
            depths.append(bits - self.cap_height)
        return tuple(depths)

    def gates(self):
        return [gate_from_id(g) for g in self.gate_ids]

    def assert_noncanonical_indices_ok(self):
        """Protocol-safety sanity check (reference fri/fri_utils.go:156-163,
        itself a port of plonky2's assert_noncanonical_indices_ok): the
        fraction of u64 values with two GL encodings must be negligible
        relative to the per-query soundness error, else non-canonical
        transcript encodings could bias FRI query indices."""
        P = (1 << 64) - (1 << 32) + 1
        num_ambiguous = (1 << 64) - P
        query_error = 1.0 / (1 << self.rate_bits)
        p_ambiguous = num_ambiguous / float(P)
        if p_ambiguous >= query_error * 1e-5:
            raise ValueError(
                "non-negligible fraction of field elements permit "
                "non-canonical encodings for this rate; need canonical "
                "encoding enforcement (reference fri/fri_utils.go:156-163)")


def load_circuit_spec(path):
    with open(path) as f:
        raw = json.load(f)
    cfg = raw["config"]
    fri_params = raw["fri_params"]
    if fri_params["hiding"]:
        raise ValueError("hiding circuits not supported "
                         "(reference types/common_data.go:121-124)")
    sel = raw["selectors_info"]
    spec = CircuitSpec(
        num_wires=cfg["num_wires"],
        num_routed_wires=cfg["num_routed_wires"],
        num_constants_cfg=cfg["num_constants"],
        security_bits=cfg["security_bits"],
        num_challenges=cfg["num_challenges"],
        rate_bits=fri_params["config"]["rate_bits"],
        cap_height=fri_params["config"]["cap_height"],
        pow_bits=fri_params["config"]["proof_of_work_bits"],
        num_query_rounds=fri_params["config"]["num_query_rounds"],
        degree_bits=fri_params["degree_bits"],
        reduction_arity_bits=tuple(fri_params["reduction_arity_bits"]),
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
    spec.assert_noncanonical_indices_ok()
    return spec
