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

The public-input hash (``hash/poseidon_gl.hash_no_pad``) is the same sponge
over the inputs cut into blocks of 8 (``hash_absorb``): on the card it is
a second launch of this kernel (``hash_no_pad_kernel``).  ``sponge_plain``
is the scan both plain versions share.

``run_transcript`` launches the kernel for CUDA tensors and raises if it
cannot; it takes ``run_transcript_plain`` only for CPU tensors.
``run_transcript_kernel.launches`` and ``hash_no_pad_kernel.launches``
count kernel launches.
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


def sponge_plain(absorb, mask):
    """The kernel's function in torch: from a zero state, for each block p,
    rate slot s overwritten by absorb[p, s] where mask[p, s], then the
    permutation.  absorb: GL pair (n_perms, 8, B); mask: (n_perms, 8) ->
    the states, GL pair (n_perms, B, 12)."""
    n_perms, _, B = absorb[0].shape
    mask = mask.bool()
    state = gl.zeros((B, WIDTH), absorb[0].device)
    out_lo, out_hi = [], []
    for p in range(n_perms):
        blk = (absorb[0][p].T, absorb[1][p].T)                     # (B, 8)
        rate = gl.select(mask[p], blk, (state[0][:, :RATE], state[1][:, :RATE]))
        state = pgl.permute(gl.concat([rate, (state[0][:, RATE:],
                                              state[1][:, RATE:])]))
        out_lo.append(state[0])
        out_hi.append(state[1])
    return torch.stack(out_lo), torch.stack(out_hi)


def run_transcript_plain(schedule, obs, pi_hash):
    """Torch scan, the same function as the kernel (and _run_transcript_jnp)."""
    absorb = gather_absorb(schedule, obs, pi_hash)
    return sponge_plain(absorb, schedule_tables(schedule, obs[0].device)[1])


def hash_absorb(inputs):
    """HashNoPad's inputs, GL pair (..., n) with n > 0, as the sponge's
    absorb blocks, GL pair (ceil(n/8), 8, B) with B the lead dims flattened
    and the last block padded with zeros, and its mask (ceil(n/8), 8) uint8:
    slot s of block p is taken where 8p + s < n.  Torch ops on the inputs'
    device; the mask is made once per n and device."""
    n = inputs[0].shape[-1]
    n_perms = -(-n // RATE)

    def blocks(x):
        x = torch.nn.functional.pad(x.reshape(-1, n), (0, n_perms * RATE - n))
        return x.reshape(-1, n_perms, RATE).permute(1, 2, 0).contiguous()

    mask = np.arange(n_perms * RATE).reshape(n_perms, RATE) < n
    return ((blocks(inputs[0]), blocks(inputs[1])),
            gl.device_table(mask, inputs[0].device, np.uint8))


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


def _check(tensors, what):
    device = tensors[0].device
    if device.type != "cuda":
        raise build.KernelError(f"no {what} kernel for {device}")
    for t in tensors:
        if t.dtype != torch.int64 or t.device != device:
            raise ValueError(f"{what}: inputs must be int64 on one CUDA device")
    return device


def _sponge_kernel(absorb, mask, what):
    """One launch of the kernel on contiguous absorb blocks (n_perms, 8, B)
    and a uint8 mask (n_perms, 8): the states as (n_perms, 12, B) planes."""
    device = absorb[0].device
    n_perms, _, B = absorb[0].shape
    out_lo = torch.empty((n_perms, WIDTH, B), dtype=torch.int64, device=device)
    out_hi = torch.empty_like(out_lo)
    consts = _kernel_consts(device)
    with torch.cuda.device(device):  # the launch goes to the current device
        rc = build.library().p2t_transcript(
            absorb[0].data_ptr(), absorb[1].data_ptr(), mask.data_ptr(),
            consts.data_ptr(), out_lo.data_ptr(), out_hi.data_ptr(), n_perms,
            B, build.stream_handle(device))
    build.check(rc, f"{what} launch")
    return out_lo, out_hi


def run_transcript_kernel(schedule, obs, pi_hash):
    """One launch of the transcript kernel; CUDA tensors only."""
    device = _check((*obs, *pi_hash), "transcript")
    absorb = gather_absorb(schedule, obs, pi_hash)
    _, mask = schedule_tables(schedule, device)
    out_lo, out_hi = _sponge_kernel(absorb, mask, "transcript")
    run_transcript_kernel.launches += 1
    return out_lo.transpose(1, 2), out_hi.transpose(1, 2)


def hash_no_pad_kernel(inputs, n_outputs=pgl.HASH_SIZE):
    """HashNoPad (``hash/poseidon_gl.hash_no_pad_plain``) as one launch of
    the transcript kernel over ``hash_absorb``'s blocks: words 0..n_outputs-1
    of the last state.  inputs: GL pair (..., n) on a CUDA device -> GL pair
    (..., n_outputs); n = 0 gives zeros without a launch.
    ``hash_no_pad_kernel.launches`` counts its launches."""
    device = _check(inputs, "public-input hash")
    lead, n = tuple(inputs[0].shape[:-1]), inputs[0].shape[-1]
    if n == 0:
        return gl.zeros(lead + (n_outputs,), device)
    absorb, mask = hash_absorb(inputs)
    out_lo, out_hi = _sponge_kernel(absorb, mask, "public-input hash")
    hash_no_pad_kernel.launches += 1

    def words(x):
        return x[-1, :n_outputs].T.reshape(lead + (n_outputs,))

    return words(out_lo), words(out_hi)


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
hash_no_pad_kernel.launches = 0
