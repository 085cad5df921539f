"""Multi-process verification on ``torch.distributed``: one process per GPU.

Counterpart of ``plonky2_tpu/parallel/distributed.py``, and the port's
scale-out path: each rank drives its own device from its own Python thread,
so the host's launch rate grows with the ranks (a mesh of several GPUs in one
process shares one thread, ``parallel/mesh.py``).

- ``initialize()`` wires the process group; by default from the variables
  ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``).
- Each rank works on one explicit device: ``cuda:{LOCAL_RANK}`` unless the
  caller names another, or the CPU.  The backend follows the device: NCCL
  for CUDA ranks, gloo for CPU ranks.  Ranks that share one GPU must name
  gloo, since NCCL refuses two ranks on one card.
- Each rank feeds only its own shard (``feed_local_batch``); no rank builds
  the global batch.
- The only cross-rank traffic: an all_gather of the local batch sizes (they
  must be equal), an all_gather of the verdict bits and an all_reduce of the
  accept count.  Verification is read-only.

    torchrun --nproc-per-node N my_verifier.py   # in it:
        distributed.initialize()
        verdicts, n_accept = distributed.verify_batch_distributed(spec, local)
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .. import verifier


def local_device(device=None):
    """This rank's device: ``device`` when given, else ``cuda:{LOCAL_RANK}``
    (which raises without a GPU)."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return verifier.resolve_device(device)


def initialize(backend=None, init_method=None, world_size=None, rank=None,
               device=None):
    """Start this process's group; nothing if it is already up.

    ``init_method`` defaults to the environment (``env://``), as do
    ``world_size`` and ``rank``.  ``backend`` defaults to NCCL when this
    rank's device (``local_device(device)``) is a GPU, gloo when it is the
    CPU; a CUDA rank makes its device current."""
    if dist.is_initialized():
        return
    device = local_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)


def _collective_device(device):
    # NCCL moves CUDA tensors only; gloo's all_gather takes host tensors only
    return device if dist.get_backend() == "nccl" else torch.device("cpu")


def _all_gather(t):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts)


def feed_local_batch(spec, local_batch, device=None):
    """This rank's shard on its device: (schedule, tensor dict, observed
    sequence), as ``verifier.prepare`` makes them."""
    return verifier.prepare(spec, local_batch, local_device(device))


def verify_batch_distributed(spec, local_batch, device=None, valid_mask=None):
    """Verify this rank's ``local_batch``; every rank gets all verdicts.

    Every rank passes a local batch of the same size, or every rank raises
    ``ValueError``.  The global layout is [rank 0 lanes | rank 1 lanes |
    ...].  The batch's ingest mask and the caller's ``valid_mask`` ((B_local,)
    bool) make this rank's quarantined lanes False before the gather.

    Returns (verdicts, n_accept): the global (B_local * world,) bool numpy
    vector, the same on every rank, and the number of accepted lanes."""
    device = local_device(device)
    cdev = _collective_device(device)
    b_local = local_batch["pow_witness"].shape[0]
    sizes = _all_gather(torch.tensor([b_local], dtype=torch.int64,
                                     device=cdev)).tolist()
    if len(set(sizes)) != 1:
        raise ValueError(f"local batch sizes differ across ranks: {sizes}; "
                         f"every rank must pass the same number of proofs")
    schedule, dev, obs = feed_local_batch(spec, local_batch, device)
    verdict = verifier.verify_device(spec, schedule, dev, obs).cpu().numpy()
    verdict = verifier.apply_valid_masks(verdict, local_batch, valid_mask)
    bits = _all_gather(torch.as_tensor(verdict.astype(np.uint8), device=cdev))
    n_accept = torch.tensor([int(verdict.sum())], dtype=torch.int64,
                            device=cdev)
    dist.all_reduce(n_accept)
    return bits.cpu().numpy().astype(bool), int(n_accept.item())
