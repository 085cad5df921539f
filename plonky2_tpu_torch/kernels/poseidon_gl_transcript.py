"""Fiat-Shamir transcript scan: wrapper of the CUDA kernel
``csrc/poseidon_gl_transcript.cu`` and its plain torch version.

Replaces the Pallas TPU kernel ``plonky2_tpu/kernels/poseidon_gl_pallas.py``
(``run_transcript_kernel`` -> ``_kernel``).  One launch runs the whole duplex
sponge of a batch: one proof a group of 16 threads, thread k holding state
word k, the n_perms permutations in order.  On the H100 it is latency-bound
by nature (a chain of dependent products per proof, a few hundred proofs on
132 SMs; see the source's header).  ``mul_chain`` times one dependent
Goldilocks product for that bound; it is on no path.

As on the TPU, the absorb blocks are gathered outside the kernel into
``(n_perms, 8, B)``, after the public-input hash lanes are written into the
observed sequence at ``schedule.pi_hash_offset``.  The result is the stacked
post-permutation states, a GL pair of shape ``(n_perms, B, 12)``.

``run_transcript`` launches the kernel for CUDA tensors and raises if it
cannot; it takes ``run_transcript_plain`` only for CPU tensors.
``run_transcript_kernel.launches`` counts kernel launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import goldilocks as gl
from ..hash import poseidon_gl as pgl
from . import build

WIDTH = pgl.WIDTH
RATE = pgl.RATE


def _with_pi_hash(schedule, obs, pi_hash):
    off = schedule.pi_hash_offset
    lo, hi = obs[0].clone(), obs[1].clone()
    lo[:, off:off + 4] = pi_hash[0]
    hi[:, off:off + 4] = pi_hash[1]
    return lo, hi


def schedule_tables(schedule, device):
    """The schedule's gather index (flat int64) and mask ((n_perms, 8)
    uint8) on ``device``, copied once per schedule and device
    (``goldilocks.device_table``): a copy from host memory waits for the
    device, so it stays off the per-batch path."""
    return (gl.device_table(schedule.gather_idx.reshape(-1), device, np.int64),
            gl.device_table(schedule.mask.reshape(-1, RATE), device, np.uint8))


def gather_absorb(schedule, obs, pi_hash):
    """Absorb blocks (n_perms, 8, B) as a GL pair, pi-hash lanes included."""
    lo, hi = _with_pi_hash(schedule, obs, pi_hash)
    g, _ = schedule_tables(schedule, lo.device)
    B = lo.shape[0]

    def blocks(x):
        return x[:, g].reshape(B, schedule.n_perms, RATE).permute(1, 2, 0)

    return blocks(lo).contiguous(), blocks(hi).contiguous()


def run_transcript_plain(schedule, obs, pi_hash):
    """Torch scan, the same function as the kernel (and _run_transcript_jnp)."""
    absorb = gather_absorb(schedule, obs, pi_hash)
    mask = schedule_tables(schedule, obs[0].device)[1].bool()  # (n_perms, 8)
    B = obs[0].shape[0]
    state = gl.zeros((B, WIDTH), obs[0].device)
    out_lo, out_hi = [], []
    for p in range(schedule.n_perms):
        blk = (absorb[0][p].T, absorb[1][p].T)                     # (B, 8)
        rate = gl.select(mask[p], blk, (state[0][:, :RATE], state[1][:, :RATE]))
        state = pgl.permute(gl.concat([rate, (state[0][:, RATE:],
                                              state[1][:, RATE:])]))
        out_lo.append(state[0])
        out_hi.append(state[1])
    return torch.stack(out_lo), torch.stack(out_hi)


@functools.lru_cache(maxsize=16)
def _kernel_consts(device):
    """u64 constant buffer in the kernel's OFF_* order."""
    C = pgl.consts()

    def flat(pair):
        return (np.asarray(pair[0], np.uint64)
                | (np.asarray(pair[1], np.uint64) << np.uint64(32))).reshape(-1)

    parts = [flat(C["rc_first"]), flat(C["rc_second"]), flat(C["first_const"]),
             flat(C["part_const"]), flat(C["init_mat12"]), flat(C["w_full"]),
             flat(C["vs_full"]), np.asarray(C["mds"], np.uint64).reshape(-1)]
    buf = np.concatenate(parts)
    n_const = build.library().p2t_transcript_n_const()
    if buf.size != n_const:
        raise build.KernelError(
            f"constant buffer has {buf.size} words, kernel wants {n_const}")
    return torch.from_numpy(buf.view(np.int64).copy()).to(device)


def run_transcript_kernel(schedule, obs, pi_hash):
    """One launch of the transcript kernel; CUDA tensors only."""
    device = obs[0].device
    if device.type != "cuda":
        raise build.KernelError(f"no transcript kernel for {device}")
    for t in (*obs, *pi_hash):
        if t.dtype != torch.int64 or t.device != device:
            raise ValueError("obs and pi_hash must be int64 on one CUDA device")
    absorb_lo, absorb_hi = gather_absorb(schedule, obs, pi_hash)
    _, mask = schedule_tables(schedule, device)
    n_perms, B = schedule.n_perms, obs[0].shape[0]
    out_lo = torch.empty((n_perms, WIDTH, B), dtype=torch.int64, device=device)
    out_hi = torch.empty_like(out_lo)
    consts = _kernel_consts(device)
    with torch.cuda.device(device):  # the launch goes to the current device
        rc = build.library().p2t_transcript(
            absorb_lo.data_ptr(), absorb_hi.data_ptr(), mask.data_ptr(),
            consts.data_ptr(), out_lo.data_ptr(), out_hi.data_ptr(), n_perms,
            B, build.stream_handle(device))
    build.check(rc, "transcript launch")
    run_transcript_kernel.launches += 1
    return out_lo.transpose(1, 2), out_hi.transpose(1, 2)


def mul_chain(x0, n, device):
    """Measurement aid: ``x0`` squared ``n`` times in Goldilocks by one GPU
    thread, each product waiting on the last; returns the (1,) int64 result
    tensor (the u64's bits) without synchronising."""
    out = torch.empty((1,), dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):
        rc = build.library().p2t_gl_mul_chain(out.data_ptr(), x0, n,
                                               build.stream_handle(out.device))
    build.check(rc, "gl_mul_chain launch")
    return out


def run_transcript(schedule, obs, pi_hash):
    """obs: GL pair (B, n_obs); pi_hash: GL pair (B, 4) ->
    GL pair (n_perms, B, 12)."""
    if obs[0].device.type == "cpu":
        return run_transcript_plain(schedule, obs, pi_hash)
    return run_transcript_kernel(schedule, obs, pi_hash)


run_transcript_kernel.launches = 0
