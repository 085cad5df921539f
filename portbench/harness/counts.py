"""The yardstick's arithmetic: work counted from the circuit's spec and the
batch, and the card's peaks.

The spec is the plain reference's parse of ``common_circuit_data.json``
(``reference/plain_verifier.load_spec``), never the port's.
"""

from __future__ import annotations

# Peaks by card name (torch.cuda.get_device_name). IMADs are 32-bit integer
# multiply-adds: 64 an SM a clock (Hopper's integer units), at the SM clock
# named by "sm_clock_hz". The clock is the card's highest, as nvidia-smi
# reports it under clocks.max.sm (1980 MHz on the H100 SXM), not the clock
# under load, so a share against it errs low, never high. The int8 tensor
# cores' rate and the memory rate are NVIDIA's data sheet (SXM, dense).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "sms": 132,
        "imad_per_sm_clock": 64,
        "sm_clock_hz": 1.98e9,
        "sm_clock_source": "clocks.max.sm, nvidia-smi (assumed under load)",
        "int8_ops_per_s": 1.979e15,
        "hbm_bytes_per_s": 3.35e12,
    },
}

# A Poseidon-BN254 permutation in each of its two known forms. A general
# 256-bit product and its Montgomery reduction are 8 x 8 32-bit word
# products, lo and hi (128 IMADs); a squaring 36 word products (72 IMADs).
# Of the 88 x^5 S-boxes' 264 products, 176 are squarings. The CIOS form
# adds 520 products by constants in the linear layers and 520 reductions;
# the tensor-core form keeps the S-boxes and 520 reductions on the IMADs and
# puts the 64 rounds' linear layers on the int8 tensor cores, 128 x 128
# byte products (2 operations each) a round.
BN254_SBOX_IMADS = 88 * 128 + 176 * 72
BN254_CIOS_IMADS = BN254_SBOX_IMADS + (520 + 520) * 128
BN254_TC_IMADS = BN254_SBOX_IMADS + 520 * 128
BN254_TC_INT8_OPS = 64 * 128 * 128 * 2


def leaf_sizes(spec):
    """Elements in each initial-tree leaf: preprocessed (constants and
    sigmas), wires, Zs and partial products, quotient."""
    return (spec.num_constants + spec.num_routed_wires, spec.num_wires,
            spec.num_challenges * (1 + spec.num_partial_products),
            spec.num_challenges * spec.quotient_degree_factor)


def step_depths(spec):
    bits, depths = spec.lde_bits, []
    for a in spec.reduction_arity_bits:
        bits -= a
        depths.append(bits - spec.cap_height)
    return depths


def bn254_permutations(spec, batch):
    """Poseidon-BN254 permutations that FRI's Merkle checks take for
    ``batch`` proofs: in each query round, each initial-tree leaf's sponge
    (9 elements a permutation) and its climb, then each commit-phase
    step's leaf (2 x arity elements) and its climb."""
    initial_depth = spec.lde_bits - spec.cap_height
    per_round = sum((n + 8) // 9 for n in leaf_sizes(spec))
    per_round += len(leaf_sizes(spec)) * initial_depth
    for a, depth in zip(spec.reduction_arity_bits, step_depths(spec)):
        per_round += (2 * (1 << a) + 8) // 9 + depth
    return batch * spec.num_query_rounds * per_round


def merkle_bytes(spec, batch):
    """Bytes FRI's Merkle checks must read and write: each leaf element (8
    B) and sibling (32 B) read once, each root (32 B) written."""
    depths = step_depths(spec)
    initial_depth = spec.lde_bits - spec.cap_height
    per_round = 8 * sum(leaf_sizes(spec)) + 32 * 4 * initial_depth
    per_round += sum(8 * 2 * (1 << a) + 32 * d
                     for a, d in zip(spec.reduction_arity_bits, depths))
    per_round += 32 * (4 + len(depths))
    return batch * spec.num_query_rounds * per_round


def imad_per_s(peaks):
    return peaks["sms"] * peaks["imad_per_sm_clock"] * peaks["sm_clock_hz"]


def bn254_bound_s(perms, nbytes, peaks):
    """The least time for ``perms`` permutations moving ``nbytes``: the
    larger of the operations' time in the cheaper form and the bytes'."""
    rate = imad_per_s(peaks)
    cios = perms * BN254_CIOS_IMADS / rate
    tensor_core = max(perms * BN254_TC_IMADS / rate,
                      perms * BN254_TC_INT8_OPS / peaks["int8_ops_per_s"])
    return max(min(cios, tensor_core), nbytes / peaks["hbm_bytes_per_s"])
