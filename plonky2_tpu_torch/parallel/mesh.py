"""Proof-batch and FRI-query sharding over the devices of one process.

Counterpart of ``plonky2_tpu/parallel/mesh.py``.  A mesh is an array of
torch devices with axis names.  ``verify_batch_sharded`` splits the proof
batch into contiguous shards, one per device ("proof" axis);
``verify_batch_sharded_2d`` also splits the FRI query rounds into contiguous
blocks over a second axis ("query"), and a proof is valid when no query
shard rejects it (the JAX mesh's psum of reject bits, here an AND on the
host).  Each shard is prepared and verified on its own device; the verdicts
are gathered to the host.

On GPUs each shard runs the compiled verifier of its key
(``verifier.verify_on_device``: one CUDA graph per spec, shard size,
device, kernel and query window), and every shard's replay is issued before
any verdict is read, so shards on different cards overlap, as one
``shard_map`` program does.  Shards with one key (a device named twice,
proof shards of one size) share a graph; each replay's outputs are cloned
before the next.  On the CPU one thread runs every shard's eager
``verify_device`` in turn.  A mesh may name one device more than once: on
the CPU that stands in for the JAX tests' virtual devices, and on one GPU
it runs several shards.

Usage:
    mesh = make_mesh()                     # every GPU on axis "proof"
    verdicts = verify_batch_sharded(spec, proof_batch, mesh)

    mesh2 = make_mesh_2d(shape=(4, 2))     # ("proof", "query")
    verdicts = verify_batch_sharded_2d(spec, proof_batch, mesh2)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import verifier
from ..fri.verify import query_rounds
from ..proof import serde


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: numpy object array of ``torch.device``, one axis per
    entry of ``axis_names``."""
    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))


def _device_array(devices):
    """Every CUDA device by default (raises without one); the CPU only when
    the caller lists it."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device: a mesh spans the GPUs unless "
                               "the caller lists CPU devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    out = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        out[i] = verifier.resolve_device(d)
    return out


def make_mesh(devices=None):
    """1-D mesh, axis "proof"."""
    return Mesh(_device_array(devices), ("proof",))


def make_mesh_2d(devices=None, shape=None):
    """2-D mesh over ("proof", "query"): the proof batch and the FRI query
    rounds, for when the proof batch alone cannot fill the devices (the
    query rounds of a proof are independent, reference
    fri/fri.go:533-547).  ``shape`` defaults to (n_devices, 1)."""
    devices = _device_array(devices)
    if shape is None:
        shape = (devices.size, 1)
    return Mesh(devices.reshape(shape), ("proof", "query"))


def pad_batch(proof_batch, multiple):
    """Pad the leading batch axis up to a multiple by repeating lane 0.

    Returns (padded_batch, real_count).  Padding lanes are copies of a real
    lane; callers slice verdicts back to ``real_count``."""
    B = proof_batch["pow_witness"].shape[0]
    pad = (-B) % multiple
    if pad == 0:
        return proof_batch, B
    out = {k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)], axis=0)
           for k, v in proof_batch.items()}
    return out, B


def _lanes(batch, i, n):
    """The i-th of n contiguous lane blocks of a batch."""
    per = batch["pow_witness"].shape[0] // n
    return {k: v[i * per:(i + 1) * per] for k, v in batch.items()}


def verify_batch_sharded(spec, proof_batch, mesh, valid_mask=None):
    """Verify a batched serde dict with the batch axis split over every
    device of ``mesh``.  Returns (B,) bool.

    Uneven batches are padded up to the mesh size with copies of lane 0 and
    the verdict vector sliced back, so any B >= 1 works on any mesh.  The
    batch's ingest mask and the caller's ``valid_mask`` apply as in
    ``verifier.verify_batch``.  This is the 2-D path on a mesh of one query
    shard, which holds every round."""
    column = Mesh(mesh.devices.reshape(-1, 1), ("proof", "query"))
    return verify_batch_sharded_2d(spec, proof_batch, column, valid_mask)


def verify_batch_sharded_2d(spec, proof_batch, mesh, valid_mask=None,
                            diagnostics=False):
    """Verify with the proof batch split over the mesh's "proof" axis and
    the FRI query rounds over its "query" axis.  Returns (B,) bool.

    Shard (i, j) verifies proof shard i on query rounds block j; it repeats
    the public-input hash, the transcript and the PLONK check, as a JAX 2-D
    mesh does.  A lane is valid when every query shard accepts it, and the
    ingest mask and ``valid_mask`` apply as in ``verifier.verify_batch``.
    With diagnostics, returns {"verdict": (B,), "query_shards": (B, n_query)
    bool, each query shard's own verdict before the masks}."""
    n_proof, n_query = mesh.shape["proof"], mesh.shape["query"]
    windows = [query_rounds(spec, (j, n_query)) for j in range(n_query)]
    padded, B = pad_batch(proof_batch, n_proof)
    qkeys = set(serde.query_axis_keys(spec))
    shards = np.empty((n_proof, n_query), dtype=object)
    for i in range(n_proof):
        lanes = _lanes(padded, i, n_proof)
        for j, (start, stop) in enumerate(windows):
            part = {k: (v[:, start:stop] if k in qkeys else v)
                    for k, v in lanes.items()}
            shards[i, j] = verifier.verify_on_device(
                spec, part, mesh.devices[i, j],
                query_shard=(j, n_query))["verdict"]
    per_shard = np.stack(
        [np.concatenate([shards[i, j].cpu().numpy() for i in range(n_proof)])
         for j in range(n_query)], axis=-1)[:B]
    verdict = verifier.apply_valid_masks(per_shard.all(axis=-1), proof_batch,
                                         valid_mask)
    if diagnostics:
        return {"verdict": verdict, "query_shards": per_shard}
    return verdict
