"""Fiat-Shamir transcript (duplex Poseidon-GL sponge).

Counterpart of ``plonky2_tpu/transcript/challenger.py``.  For a fixed circuit
shape the whole absorb/squeeze schedule is static, so the transcript is

  1. a host-side simulation (``_Sim``, ``build_schedule``) that records, for
     every permutation, which observed-sequence elements overwrite which
     state slots, and for every challenge, (permutation index, state slot);
  2. one scan over the permutations for the whole batch (``run_transcript``:
     the CUDA kernel on the GPU, the plain torch scan on the CPU);
  3. static reads of every challenge from the stacked states.

Challenges pop from the *end* of the output buffer, as in plonky2.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..hash import poseidon_gl as pgl
from ..kernels import poseidon_gl_transcript as _scan

RATE = pgl.RATE
WIDTH = pgl.WIDTH


class _Sim:
    """Host-side schedule recorder mirroring challenger.go semantics."""

    def __init__(self):
        self.n_obs = 0            # length of observed sequence so far
        self.input_buffer = []    # indices into observed sequence
        self.output_count = 0     # remaining output-buffer entries
        self.perm_inputs = []     # per permutation: list of obs indices
        self.n_perms = 0

    def observe(self, count=1):
        first = self.n_obs
        for _ in range(count):
            idx = self.n_obs
            self.n_obs += 1
            self.output_count = 0
            self.input_buffer.append(idx)
            if len(self.input_buffer) == RATE:
                self._duplex()
        return first

    def _duplex(self):
        self.perm_inputs.append(list(self.input_buffer))
        self.input_buffer = []
        self.output_count = RATE
        self.n_perms += 1

    def get_challenge(self):
        if self.input_buffer or self.output_count == 0:
            self._duplex()
        self.output_count -= 1
        slot = self.output_count  # pops from the end: slot RATE-1 downward
        return (self.n_perms - 1, slot)

    def get_n(self, n):
        return [self.get_challenge() for _ in range(n)]


@dataclasses.dataclass
class TranscriptSchedule:
    """Static transcript layout for one circuit spec."""
    n_obs: int
    n_perms: int
    gather_idx: np.ndarray   # (n_perms, RATE) int32 indices into obs seq
    mask: np.ndarray         # (n_perms, RATE) bool: overwrite state slot?
    pi_hash_offset: int      # where the 4 pi-hash lanes live in the obs seq
    # challenge read positions: (perm, slot) pairs
    plonk_betas: list
    plonk_gammas: list
    plonk_alphas: list
    plonk_zeta: list
    fri_alpha: list
    fri_betas: list          # list per commit cap: [(p,s), (p,s)]
    fri_pow_response: tuple
    fri_query_indices: list


def build_schedule(spec, final_poly_len=None):
    """Simulate the full GetChallenges transcript for `spec`
    (reference verifier/verifier.go:45-82)."""
    sim = _Sim()
    nc = spec.num_challenges
    cap = spec.cap_size

    sim.observe(5)                     # circuit digest ToVec chunks
    pi_off = sim.observe(4)            # public inputs hash
    sim.observe(cap * 5)               # wires cap
    betas = sim.get_n(nc)
    gammas = sim.get_n(nc)
    sim.observe(cap * 5)               # Zs+partial products cap
    alphas = sim.get_n(nc)
    sim.observe(cap * 5)               # quotient polys cap
    zeta = sim.get_n(2)
    # openings: batch at zeta (all categories) then batch at g*zeta (zs_next)
    n_batch0 = (spec.num_constants + spec.num_routed_wires + spec.num_wires
                + nc + nc * spec.num_partial_products
                + spec.num_quotient_polys)
    sim.observe(n_batch0 * 2)
    sim.observe(spec.num_challenges * 2)  # zs_next
    # GetFriChallenges (reference challenger/challenger.go:117-144)
    fri_alpha = sim.get_n(2)
    fri_betas = []
    for _ in spec.reduction_arity_bits:
        sim.observe(cap * 5)
        fri_betas.append(sim.get_n(2))
    fp_len = final_poly_len if final_poly_len is not None else spec.final_poly_len
    sim.observe(fp_len * 2)            # final poly coeffs
    sim.observe(1)                     # pow witness
    pow_resp = sim.get_challenge()
    query_indices = sim.get_n(spec.num_query_rounds)

    gather = np.zeros((sim.n_perms, RATE), dtype=np.int32)
    mask = np.zeros((sim.n_perms, RATE), dtype=bool)
    for p, inputs in enumerate(sim.perm_inputs):
        for j, idx in enumerate(inputs):
            gather[p, j] = idx
            mask[p, j] = True

    return TranscriptSchedule(
        n_obs=sim.n_obs, n_perms=sim.n_perms, gather_idx=gather, mask=mask,
        pi_hash_offset=pi_off, plonk_betas=betas, plonk_gammas=gammas,
        plonk_alphas=alphas, plonk_zeta=zeta, fri_alpha=fri_alpha,
        fri_betas=fri_betas, fri_pow_response=pow_resp,
        fri_query_indices=query_indices)


def build_observed_host(spec, proof):
    """Assemble the host-known part of the observed sequence (numpy uint64).

    proof: unbatched or batched serde dict.  Returns (B?, n_obs) uint64 with
    zeros at the pi-hash slots (filled on device).
    """
    batched = proof["circuit_digest_tovec"].ndim == 2
    B = proof["circuit_digest_tovec"].shape[0] if batched else None

    def flat(x):
        x = np.asarray(x, dtype=np.uint64)
        if batched:
            return x.reshape(B, -1)
        return x.reshape(-1)

    parts = [
        flat(proof["circuit_digest_tovec"]),
        np.zeros((B, 4) if batched else (4,), dtype=np.uint64),  # pi hash
        flat(proof["wires_cap_tovec"]),
    ]
    parts += [flat(proof["zs_pp_cap_tovec"]), flat(proof["quotient_cap_tovec"])]
    # openings batch 0 order (reference fri/fri.go:63-73)
    parts += [flat(proof["op_constants"]), flat(proof["op_plonk_sigmas"]),
              flat(proof["op_wires"]), flat(proof["op_plonk_zs"]),
              flat(proof["op_partial_products"]),
              flat(proof["op_quotient_polys"]),
              flat(proof["op_plonk_zs_next"])]
    n_steps = proof["commit_caps_tovec"].shape[-3]
    for j in range(n_steps):
        parts.append(flat(proof["commit_caps_tovec"][..., j, :, :]))
    parts += [flat(proof["final_poly"]),
              flat(proof["pow_witness"][..., None]
                   if batched else [proof["pow_witness"]])]
    axis = 1 if batched else 0
    return np.concatenate(parts, axis=axis)


def run_transcript(schedule, obs, pi_hash):
    """Stacked post-permutation states, a GL pair (n_perms, B, 12).

    obs: GL pair (B, n_obs) with the host-known observed sequence;
    pi_hash: GL pair (B, 4), written in at ``schedule.pi_hash_offset``."""
    return _scan.run_transcript(schedule, obs, pi_hash)


def read_challenge(states, pos):
    """(perm, slot) -> GL value of shape (B,)."""
    p, s = pos
    return (states[0][p, :, s], states[1][p, :, s])


def read_qe(states, pos_pair):
    return (read_challenge(states, pos_pair[0]),
            read_challenge(states, pos_pair[1]))
