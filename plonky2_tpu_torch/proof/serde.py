"""Proof ingestion: plonky2 JSON -> struct-of-arrays numpy bundles.

Counterpart of ``plonky2_tpu/proof/serde.py``: every array it returns is
identical (values, dtypes, shapes) to the reference's ``ingest_proof``, and
``ingest_batch`` quarantines malformed proofs the same way.  The host helpers
it needs come from the port's jax-free field and hash modules.

Consumes the exact JSON formats of the reference (types/deserialize.go,
variables/deserialize.go): proof_with_public_inputs.json and
verifier_only_circuit_data.json.  Beyond raw parsing, this host-side layer
precomputes everything the device kernels would otherwise waste cycles on:

- BN254 digests (caps, siblings, circuit digest) as Montgomery limb arrays,
  so the device compares digests without domain conversion;
- ToVec 56-bit chunk decompositions of every transcript-observed digest
  (reference poseidon/bn254.go:106-120);
- Merkle-leaf absorb blocks: GL leaf elements packed 3-per-BN254-element and
  Montgomery-converted (reference poseidon/bn254.go:47-77), laid out per
  (query-round, oracle, absorb-step) for one batched scan on device.

Ingestion validates every GL value is canonical (< p) -- the native analog of
the reference's rangeCheckProof (verifier/verifier.go:84-141): a proof with
out-of-range elements is rejected at load time.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..fields import goldilocks as gl
from ..fields import bn254
from ..hash import poseidon_bn254 as pb

TOVEC_CHUNKS = 5  # ceil(254 / 56)
VALID_MASK = "valid_mask"  # the (B,) bool entry of an ``ingest_batch`` batch


class InvalidProofError(ValueError):
    pass


def _gl_array(values, what):
    arr = np.asarray(values, dtype=np.uint64)
    if arr.size and int(arr.max()) >= gl.P:
        raise InvalidProofError(f"non-canonical Goldilocks element in {what}")
    return arr


def _digest_mont(dec_str, what):
    v = int(dec_str)
    if not (0 <= v < bn254.P):
        raise InvalidProofError(f"digest out of range in {what}")
    return np.asarray(bn254.int_to_mont_limbs(v), dtype=np.uint32)


def _digest_tovec(dec_str):
    """56-bit LSB-first chunks of a canonical digest
    (reference poseidon/bn254.go:106-120)."""
    v = int(dec_str)
    return np.asarray([(v >> (56 * i)) & ((1 << 56) - 1)
                       for i in range(TOVEC_CHUNKS)], dtype=np.uint64)


def absorb_slot_masks(n_elems):
    """Slot overwrite masks for HashNoPad of n_elems GL elements:
    (n_chunks, 3) bool, slot s of chunk t active iff n_elems > 9t + 3s.
    Single source of truth for serde packing and the device absorb scan."""
    n_chunks = max(1, (n_elems + 8) // 9)
    mask = np.zeros((n_chunks, 3), dtype=bool)
    for t in range(n_chunks):
        rem = n_elems - 9 * t
        for s in range(3):
            mask[t, s] = rem > 3 * s
    return mask


def _pack_leaf_mont(elements):
    """GL leaf -> list of absorb blocks, each (3,16) mont limbs + (3,) mask.

    Mirrors HashNoPad's 9-elements-per-permutation packing
    (reference poseidon/bn254.go:58-74).  For leaves of <= 3 elements the
    reference uses HashOrNoop (poseidon/bn254.go:79-94): the digest IS the
    packed value, no permutation runs; the packed block is still produced
    here (slot 0) and the device selects it directly (LeafLayout.noop)."""
    blocks = []
    n = len(elements)
    assert n > 0, "empty leaf"
    for i in range(0, n, 9):
        chunk = elements[i:i + 9]
        block = np.zeros((3, 16), dtype=np.uint32)
        mask = np.zeros((3,), dtype=bool)
        for s in range(0, len(chunk), 3):
            packed = pb.host_pack_gl_chunk(chunk[s:s + 3])
            block[s // 3] = bn254.int_to_mont_limbs(packed)
            mask[s // 3] = True
        blocks.append((block, mask))
    return blocks


@dataclasses.dataclass
class LeafLayout:
    """Static absorb layout for the 4 initial-tree oracles.

    The device hashes each oracle's leaves with its own scan of n_steps[o]
    absorb steps (oracle step counts differ widely -- e.g. 10/16/3/2 for the
    step circuit -- so a shared max-length scan would waste ~45% of the
    dispatched hash lanes on masked steps)."""
    max_steps: int
    n_steps: tuple          # per-oracle absorb step count
    slot_mask: np.ndarray   # (4, max_steps, 3) bool
    noop: np.ndarray        # (4,) bool: <=3-element leaf -> HashOrNoop


def leaf_layout(spec):
    sizes = spec.oracle_leaf_sizes
    n_steps = [max(1, (s + 8) // 9) for s in sizes]
    max_steps = max(n_steps)
    slot_mask = np.zeros((4, max_steps, 3), dtype=bool)
    noop = np.zeros((4,), dtype=bool)
    for o, size in enumerate(sizes):
        assert size > 0, "empty oracle leaf"
        noop[o] = size <= 3  # reference poseidon/bn254.go:79-94
        for t in range(n_steps[o]):
            # noop oracles still carry their packed block (slot 0) but never
            # run the sponge; the device reads the block as the digest.
            slot_mask[o, t] = absorb_slot_masks(size)[t]
    return LeafLayout(max_steps=max_steps, n_steps=tuple(n_steps),
                      slot_mask=slot_mask, noop=noop)


def load_proof(spec, proof_path, verifier_only_path):
    """Parse + validate + precompute one proof bundle (dict of numpy arrays)."""
    with open(proof_path) as f:
        raw = json.load(f)
    with open(verifier_only_path) as f:
        vraw = json.load(f)
    return ingest_proof(spec, raw, vraw)


def ingest_proof(spec, raw, vraw):
    proof = raw["proof"]
    op = proof["openings"]
    opening_proof = proof["opening_proof"]
    qrs = opening_proof["query_round_proofs"]
    Q = spec.num_query_rounds
    nsteps = len(spec.reduction_arity_bits)

    # ---- shape validation (reference fri/fri_utils.go:167-228)
    if len(qrs) != Q:
        raise InvalidProofError("wrong number of query rounds")
    if len(opening_proof["final_poly"]["coeffs"]) != spec.final_poly_len:
        raise InvalidProofError("final poly length mismatch")
    if len(opening_proof["commit_phase_merkle_caps"]) != nsteps:
        raise InvalidProofError("commit phase caps mismatch")
    for cap_name in ["wires_cap", "plonk_zs_partial_products_cap",
                     "quotient_polys_cap"]:
        if len(proof[cap_name]) != spec.cap_size:
            raise InvalidProofError(f"{cap_name} size mismatch")
    expected_op_lens = {
        "constants": spec.num_constants,
        "plonk_sigmas": spec.num_routed_wires,
        "wires": spec.num_wires,
        "plonk_zs": spec.num_challenges,
        "plonk_zs_next": spec.num_challenges,
        "partial_products": spec.num_challenges * spec.num_partial_products,
        "quotient_polys": spec.num_quotient_polys,
    }
    for k, n in expected_op_lens.items():
        if len(op[k]) != n:
            raise InvalidProofError(f"openings.{k} length mismatch")

    out = {}
    out["public_inputs"] = _gl_array(raw["public_inputs"], "public_inputs")
    if out["public_inputs"].shape != (spec.num_public_inputs,):
        raise InvalidProofError("public inputs length mismatch")

    for k in expected_op_lens:
        out[f"op_{k}"] = _gl_array(op[k], f"openings.{k}").reshape(-1, 2)
    out["final_poly"] = _gl_array(
        opening_proof["final_poly"]["coeffs"], "final_poly").reshape(-1, 2)
    out["pow_witness"] = _gl_array([opening_proof["pow_witness"]],
                                   "pow_witness")[0]

    # ---- caps / digests
    cap_keys = {"wires_cap": "wires_cap",
                "plonk_zs_partial_products_cap": "zs_pp_cap",
                "quotient_polys_cap": "quotient_cap"}
    for jk, ok in cap_keys.items():
        out[ok] = np.stack([_digest_mont(h, jk) for h in proof[jk]])
        out[f"{ok}_tovec"] = np.stack([_digest_tovec(h) for h in proof[jk]])
    out["const_sigmas_cap"] = np.stack(
        [_digest_mont(h, "constants_sigmas_cap")
         for h in vraw["constants_sigmas_cap"]])
    if out["const_sigmas_cap"].shape[0] != spec.cap_size:
        raise InvalidProofError("constants_sigmas_cap size mismatch")
    out["circuit_digest"] = _digest_mont(vraw["circuit_digest"],
                                         "circuit_digest")
    out["circuit_digest_tovec"] = _digest_tovec(vraw["circuit_digest"])

    caps, caps_tovec = [], []
    for cap in opening_proof["commit_phase_merkle_caps"]:
        if len(cap) != spec.cap_size:
            raise InvalidProofError("commit cap size mismatch")
        caps.append(np.stack([_digest_mont(h, "commit_cap") for h in cap]))
        caps_tovec.append(np.stack([_digest_tovec(h) for h in cap]))
    out["commit_caps"] = np.stack(caps) if caps else np.zeros((0, spec.cap_size, 16), np.uint32)
    out["commit_caps_tovec"] = (np.stack(caps_tovec) if caps_tovec
                                else np.zeros((0, spec.cap_size, 5), np.uint64))

    # ---- query rounds
    layout = leaf_layout(spec)
    sizes = spec.oracle_leaf_sizes
    depth = spec.initial_tree_depth
    leaves = [np.zeros((Q, sizes[o]), dtype=np.uint64) for o in range(4)]
    init_packed = np.zeros((Q, 4, layout.max_steps, 3, 16), dtype=np.uint32)
    init_sibs = np.zeros((Q, 4, depth, 16), dtype=np.uint32)
    step_evals = [np.zeros((Q, 1 << a, 2), dtype=np.uint64)
                  for a in spec.reduction_arity_bits]
    step_packed = []
    step_sibs = []
    for j, a in enumerate(spec.reduction_arity_bits):
        n_elems = (1 << a) * 2
        n_chunks = (n_elems + 8) // 9
        step_packed.append(np.zeros((Q, n_chunks, 3, 16), dtype=np.uint32))
        step_sibs.append(np.zeros((Q, spec.step_tree_depths[j], 16),
                                  dtype=np.uint32))

    for q, qr in enumerate(qrs):
        evals_proofs = qr["initial_trees_proof"]["evals_proofs"]
        if len(evals_proofs) != 4:
            raise InvalidProofError("expected 4 initial-tree eval proofs")
        for o, ep in enumerate(evals_proofs):
            elems, mp = ep[0], ep[1]
            if len(elems) != sizes[o]:
                raise InvalidProofError(
                    f"leaf size mismatch oracle {o}: {len(elems)} != {sizes[o]}")
            if len(mp["siblings"]) != depth:
                raise InvalidProofError("initial merkle depth mismatch")
            leaves[o][q] = _gl_array(elems, "leaf")
            for t, (block, mask) in enumerate(_pack_leaf_mont(elems)):
                init_packed[q, o, t] = block
                assert (mask == layout.slot_mask[o, t]).all()
            for lv, sib in enumerate(mp["siblings"]):
                init_sibs[q, o, lv] = _digest_mont(sib, "sibling")
        steps = qr["steps"]
        if len(steps) != nsteps:
            raise InvalidProofError("steps count mismatch")
        for j, st in enumerate(steps):
            a = spec.reduction_arity_bits[j]
            if len(st["evals"]) != (1 << a):
                raise InvalidProofError("step evals size mismatch")
            if len(st["merkle_proof"]["siblings"]) != spec.step_tree_depths[j]:
                raise InvalidProofError("step merkle depth mismatch")
            ev = _gl_array(st["evals"], "step evals").reshape(-1, 2)
            step_evals[j][q] = ev
            flat = [int(x) for pair in ev for x in pair]
            for t, (block, mask) in enumerate(_pack_leaf_mont(flat)):
                step_packed[j][q, t] = block
            for lv, sib in enumerate(st["merkle_proof"]["siblings"]):
                step_sibs[j][q, lv] = _digest_mont(sib, "step sibling")

    for o in range(4):
        out[f"init_leaves_{o}"] = leaves[o]
    out["init_leaf_packed"] = init_packed
    out["init_siblings"] = init_sibs
    for j in range(nsteps):
        out[f"step{j}_evals"] = step_evals[j]
        out[f"step{j}_leaf_packed"] = step_packed[j]
        out[f"step{j}_siblings"] = step_sibs[j]
    return out


def stack_proofs(proofs):
    """List of proof dicts (same circuit) -> batched dict (leading axis B)."""
    keys = proofs[0].keys()
    return {k: np.stack([p[k] for p in proofs]) for k in keys}


def ingest_batch(spec, raw_pairs):
    """Quarantined batch ingestion: one structurally-bad proof cannot kill
    the batch (SURVEY.md section 5, failure-detection row).

    raw_pairs: list of (proof_json_dict, verifier_only_json_dict).
    Returns (batched_dict, valid_mask, errors): lanes whose ingestion raised
    InvalidProofError are replaced by a copy of the first valid proof (so
    the batch stays shape-consistent) and masked False; `errors` maps lane
    index -> error message.  Raises only if NO lane is valid (there is no
    shape to batch).

    The batch carries the mask as its ``"valid_mask"`` entry, and
    ``verifier.verify_batch`` always applies it, so a quarantined lane is
    False even when the caller drops the returned mask.  (The JAX package's
    batch has no such entry: there the lane verifies as the filler proof
    unless the caller passes the mask.)
    """
    parsed, errors = [], {}
    for i, (raw, vraw) in enumerate(raw_pairs):
        try:
            parsed.append(ingest_proof(spec, raw, vraw))
        except (InvalidProofError, KeyError, IndexError, TypeError,
                ValueError, OverflowError) as e:
            # beyond InvalidProofError, malformed JSON structure surfaces
            # as KeyError (missing field), ValueError (ragged/bad-typed
            # array), TypeError/OverflowError (non-int values) -- all are
            # that lane's problem, not the batch's
            parsed.append(None)
            errors[i] = f"{type(e).__name__}: {e}"
    valid_mask = np.asarray([p is not None for p in parsed], dtype=bool)
    if not valid_mask.any():
        raise InvalidProofError(
            f"all {len(raw_pairs)} proofs in batch invalid: {errors}")
    filler = next(p for p in parsed if p is not None)
    parsed = [p if p is not None else filler for p in parsed]
    batch = stack_proofs(parsed)
    batch[VALID_MASK] = valid_mask
    return batch, valid_mask, errors
