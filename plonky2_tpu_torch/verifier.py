"""Top-level batched Plonky2 verifier on torch tensors.

Counterpart of ``plonky2_tpu/verifier.py``:

    range-check proof        -> at ingestion (proof/serde.py)
    public-inputs hash       -> Poseidon-GL sponge (hash/poseidon_gl.py)
    GetChallenges            -> statically scheduled transcript scan
                                (transcript/challenger.py; the CUDA kernel
                                csrc/poseidon_gl_transcript.cu on the GPU)
    PLONK vanishing check    -> plonk_checks/vanishing.py
    FRI                      -> fri/verify.py (Merkle hashing through the
                                CUDA kernel csrc/poseidon_bn254.cu, or
                                csrc/poseidon_bn254_cios.cu under
                                PLONKY2_TPU_PB_IMPL=cios, on the GPU)

``verify_batch(spec, proofs)`` verifies B same-shape proofs at once on the
GPU and returns one boolean verdict per proof; an invalid proof is data,
never an exception.  Only an explicit ``device="cpu"`` runs it on the CPU
(through the kernels' plain torch versions); without a GPU the default
raises.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from .fields import goldilocks as gl
from .hash import poseidon_gl as pgl
from .transcript import challenger as chal
from .plonk_checks.vanishing import verify_plonk
from .fri.verify import verify_fri
from .proof.convert import from_reference
from .proof.serde import VALID_MASK, stack_proofs


def resolve_device(device):
    """The torch device to run on; a CUDA device must exist, never a silent
    fall-back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the verifier runs on the GPU "
                           "unless asked for the CPU (device=\"cpu\")")
    return device


def device_name(device):
    """The card's name (``torch.cuda.get_device_name``), or ``cpu``."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


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


def verify_device(spec, schedule, dev, obs, diagnostics=False, timer=None):
    """Verify a tensor batch: dev from ``proof_to_device``, obs the observed
    sequence as a GL pair (B, n_obs) on the same device.  With a
    ``utils.profiling.StageTimer`` each stage is timed on its own."""
    def stage(name):
        return timer.stage(name) if timer else contextlib.nullcontext()

    B = obs[0].shape[0]
    with stage("pi_hash"):
        pi_hash = pgl.hash_no_pad(dev["public_inputs"])
    with stage("transcript"):
        states = chal.run_transcript(schedule, obs, pi_hash)
    with stage("challenges"):
        challenges = _extract_challenges(schedule, states)
    ones = torch.ones((B,), dtype=torch.bool, device=obs[0].device)
    with stage("plonk"):
        plonk_ok = verify_plonk(spec, dev, challenges, pi_hash, ones)
    with stage("fri"):
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


def verify_batch(spec, proof_batch, valid_mask=None, device="cuda",
                 diagnostics=False):
    """Verify a batched serde dict (leading axis B).  Returns (B,) bool.

    Runs on the GPU unless ``device="cpu"``.  Lanes that failed validation at
    load time are always False: the mask that ``serde.ingest_batch`` stores
    in the batch is applied, and so is ``valid_mask`` when the caller passes
    one (optional (B,) bool).  With diagnostics, returns a dict of (B,) bool
    arrays: verdict, plonk_ok, fri_ok."""
    device = resolve_device(device)
    schedule, dev, obs = prepare(spec, proof_batch, device)
    out = verify_device(spec, schedule, dev, obs, diagnostics=True)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    for mask in (proof_batch.get(VALID_MASK), valid_mask):
        if mask is not None:
            out["verdict"] = out["verdict"] & np.asarray(mask, dtype=bool)
    return out if diagnostics else out["verdict"]


def verify_one(spec, proof, device="cuda"):
    return bool(verify_batch(spec, stack_proofs([proof]), device=device)[0])
