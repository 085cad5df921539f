"""Multi-process verification on ``torch.distributed``: one process per GPU.

Counterpart of ``plonky2_tpu/parallel/distributed.py``, and the port's
scale-out path across processes: each rank drives its own device from its
own process, so the host work around each replay (``verifier.prepare``,
the copies) runs on as many cores as there are ranks (a mesh of several GPUs
in one process prepares its shards on one thread, ``parallel/mesh.py``).

- ``initialize()`` wires the process group; by default from the variables
  ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``).
- Each rank works on one explicit device: ``cuda:{LOCAL_RANK}`` unless the
  caller names another, or the CPU.  The backend follows the device: NCCL
  for CUDA ranks, gloo for CPU ranks.  Ranks that share one GPU must name
  gloo, since NCCL refuses two ranks on one card.
- Each rank verifies only its own shard; no rank builds the global batch
  (the JAX ``feed_local_batch`` has no counterpart).  A CUDA rank verifies
  it through the compiled verifier (``verifier.verify_on_device``, one CUDA
  graph per key); the collectives stay outside the graph.
- The only cross-rank traffic: an all_gather of each rank's local batch
  size and of whether its batch has the circuit's shape
  (``serde.batch_error``), before any rank verifies, so that a malformed
  batch on one rank makes every rank raise rather than leave the others
  waiting in a collective; an all_gather of the verdict bits and an
  all_reduce of the accept count.  Verification is read-only.

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
from ..proof import serde


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


def verify_batch_distributed(spec, local_batch, device=None, valid_mask=None):
    """Verify this rank's ``local_batch``; every rank gets all verdicts.

    Every rank passes a local batch of the same size in the circuit's shape
    (every key's shape and dtype, the query-round count among them, as
    ``serde.batch_error`` checks), or every rank raises ``ValueError``
    before any verifies (a malformed batch counts as size -1).  The global layout is [rank 0 lanes | rank 1 lanes
    | ...].  The batch's ingest mask and the caller's ``valid_mask``
    ((B_local,) bool) make this rank's quarantined lanes False before the
    gather.

    Returns (verdicts, n_accept): the global (B_local * world,) bool numpy
    vector, the same on every rank, and the number of accepted lanes."""
    device = local_device(device)
    cdev = _collective_device(device)
    # read nothing that could raise before the gather: a rank that raised
    # alone would leave the others waiting in it
    error = serde.batch_error(spec, local_batch)
    b_local = -1 if error else len(local_batch["pow_witness"])
    gathered = _all_gather(torch.tensor([b_local, error is None],
                                        dtype=torch.int64, device=cdev))
    sizes, shaped = gathered.reshape(-1, 2).T.tolist()
    if len(set(sizes)) != 1 or not all(shaped):
        raise ValueError(
            f"local batch sizes {sizes}, in the circuit's shape "
            f"{[bool(x) for x in shaped]}: every rank must pass the same "
            f"number of proofs in the circuit's shape"
            + (f" (this rank: {error})" if error else ""))
    verdict = verifier.verify_on_device(spec, local_batch,
                                        device)["verdict"].cpu().numpy()
    verdict = verifier.apply_valid_masks(verdict, local_batch, valid_mask)
    bits = _all_gather(torch.as_tensor(verdict.astype(np.uint8), device=cdev))
    n_accept = torch.tensor([int(verdict.sum())], dtype=torch.int64,
                            device=cdev)
    dist.all_reduce(n_accept)
    return bits.cpu().numpy().astype(bool), int(n_accept.item())
