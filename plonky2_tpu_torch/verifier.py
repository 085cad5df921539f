"""Top-level batched Plonky2 verifier on torch tensors.

Counterpart of ``plonky2_tpu/verifier.py``:

    range-check proof        -> at ingestion (proof/serde.py)
    public-inputs hash       -> Poseidon-GL sponge (hash/poseidon_gl.py)
    GetChallenges            -> statically scheduled transcript scan
                                (transcript/challenger.py; the CUDA kernel
                                csrc/poseidon_gl_transcript.cu on the GPU)
    PLONK vanishing check    -> plonk_checks/vanishing.py
    FRI                      -> fri/verify.py (Merkle hashing through the
                                CUDA kernel csrc/poseidon_bn254.cu on the GPU)

``verify_batch(spec, proofs, device=...)`` verifies B same-shape proofs at
once and returns one boolean verdict per proof; an invalid proof is data,
never an exception.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .fields import goldilocks as gl
from .hash import poseidon_gl as pgl
from .transcript import challenger as chal
from .plonk_checks.vanishing import verify_plonk
from .fri.verify import verify_fri
from .proof.convert import from_reference


def proof_to_device(proof, device):
    """Batched numpy serde dict -> tensor dict on ``device``."""
    return from_reference(proof, device)


def _extract_challenges(schedule, states):
    def one(pos):
        return chal.read_challenge(states, pos)

    qi = [one(p) for p in schedule.fri_query_indices]
    return {
        "plonk_betas": [one(p) for p in schedule.plonk_betas],
        "plonk_gammas": [one(p) for p in schedule.plonk_gammas],
        "plonk_alphas": [one(p) for p in schedule.plonk_alphas],
        "zeta": chal.read_qe(states, schedule.plonk_zeta),
        "fri_alpha": chal.read_qe(states, schedule.fri_alpha),
        "fri_betas": [chal.read_qe(states, p) for p in schedule.fri_betas],
        "pow_response": one(schedule.fri_pow_response),
        "query_indices": gl.stack(qi, axis=-1),
    }


def verify_device(spec, schedule, dev, obs, diagnostics=False):
    """Verify a tensor batch: dev from ``proof_to_device``, obs the observed
    sequence as a GL pair (B, n_obs) on the same device."""
    B = obs[0].shape[0]
    pi_hash = pgl.hash_no_pad(dev["public_inputs"])
    states = chal.run_transcript(schedule, obs, pi_hash)
    challenges = _extract_challenges(schedule, states)
    ones = torch.ones((B,), dtype=torch.bool, device=obs[0].device)
    plonk_ok = verify_plonk(spec, dev, challenges, pi_hash, ones)
    fri_ok = verify_fri(spec, dev, challenges, ones)
    verdict = plonk_ok & fri_ok
    if diagnostics:
        return {"verdict": verdict, "plonk_ok": plonk_ok, "fri_ok": fri_ok}
    return verdict


@functools.lru_cache(maxsize=8)
def schedule_for(spec):
    return chal.build_schedule(spec)


def prepare(spec, proof_batch, device):
    """Host side of a batch: (schedule, tensor dict, observed sequence)."""
    schedule = schedule_for(spec)
    obs = gl.split_u64(chal.build_observed_host(spec, proof_batch), device)
    return schedule, proof_to_device(proof_batch, device), obs


def verify_batch(spec, proof_batch, valid_mask=None, device="cpu",
                 diagnostics=False):
    """Verify a batched serde dict (leading axis B).  Returns (B,) bool.

    valid_mask: optional (B,) bool from ``serde.ingest_batch``; lanes that
    failed validation at load time are forced to False.  With diagnostics,
    returns a dict of (B,) bool arrays: verdict, plonk_ok, fri_ok."""
    schedule, dev, obs = prepare(spec, proof_batch, device)
    out = verify_device(spec, schedule, dev, obs, diagnostics=True)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    if valid_mask is not None:
        out["verdict"] = out["verdict"] & np.asarray(valid_mask, dtype=bool)
    return out if diagnostics else out["verdict"]


def verify_one(spec, proof, device="cpu"):
    from .proof.serde import stack_proofs
    return bool(verify_batch(spec, stack_proofs([proof]), device=device)[0])
