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
(``verifier.compiled_verifier``: one CUDA graph per spec, shard size,
device, kernel and query window), and every shard's replay is issued before
any verdict is read, so shards on different cards overlap, as one
``shard_map`` program does.  Every shard is checked on the calling thread
before any is packed.  A call whose keys are all captured hands each
device's shards to that device's feed thread, one a device, which the mesh
owns: each card's host feed (the check, the observed sequence, the pack into
the key's pinned buffer, the copy) and its replay run beside the other
cards'.  A key's first call (the eager warm-up and the capture) runs on the
calling thread, one shard after another, so that no capture overlaps work
on another thread.  Shards with one key (a device named twice, proof shards
of one size) share a graph and run in turn on one thread; each replay's
outputs are cloned before the next.  On the CPU one thread runs every
shard's eager ``verify_device`` in turn.  A mesh may name one device more
than once: on the CPU that stands in for the JAX tests' virtual devices,
and on one GPU it runs several shards.

Usage:
    mesh = make_mesh()                     # every GPU on axis "proof"
    verdicts = verify_batch_sharded(spec, proof_batch, mesh)

    mesh2 = make_mesh_2d(shape=(4, 2))     # ("proof", "query")
    verdicts = verify_batch_sharded_2d(spec, proof_batch, mesh2)
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import time

import numpy as np
import torch

from .. import verifier
from ..hash import poseidon_bn254 as pb
from ..fri.verify import query_rounds
from ..proof import serde


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: numpy object array of ``torch.device``, one axis per
    entry of ``axis_names``.  ``feeds``: the feed thread of each device
    that a call has handed shards to, started at its first use and kept;
    a mesh's views (``verify_batch_sharded``'s column) share it."""
    devices: np.ndarray
    axis_names: tuple
    feeds: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def feed(self, device):
        """The one worker thread of ``device``."""
        if device not in self.feeds:
            self.feeds[device] = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix=f"mesh-feed-{device}")
        return self.feeds[device]


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


def verify_batch_sharded(spec, proof_batch, mesh, valid_mask=None,
                         diagnostics=False, timer=None):
    """Verify a batched serde dict with the batch axis split over every
    device of ``mesh``.  Returns (B,) bool, or with diagnostics a dict of
    (B,) bool arrays, verdict, plonk_ok and fri_ok, as
    ``verifier.verify_batch`` gives them.

    Uneven batches are padded up to the mesh size with copies of lane 0 and
    the outputs sliced back, so any B >= 1 works on any mesh.  The batch's
    ingest mask and the caller's ``valid_mask`` apply to the verdict as in
    ``verifier.verify_batch``.  ``timer`` as in ``verify_batch_sharded_2d``.
    This is the 2-D path on a mesh of one query shard, which holds every
    round."""
    column = Mesh(mesh.devices.reshape(-1, 1), ("proof", "query"),
                  mesh.feeds)
    out = verify_batch_sharded_2d(spec, proof_batch, column, valid_mask,
                                  diagnostics=True, timer=timer)
    out.pop("query_shards")
    return out if diagnostics else out["verdict"]


def verify_batch_sharded_2d(spec, proof_batch, mesh, valid_mask=None,
                            diagnostics=False, timer=None):
    """Verify with the proof batch split over the mesh's "proof" axis and
    the FRI query rounds over its "query" axis.  Returns (B,) bool.

    Shard (i, j) verifies proof shard i on query rounds block j; it repeats
    the public-input hash, the transcript and the PLONK check, as a JAX 2-D
    mesh does.  A lane is valid when every query shard accepts it, and the
    ingest mask and ``valid_mask`` apply as in ``verifier.verify_batch``.
    With diagnostics, returns {"verdict": (B,), "plonk_ok": (B,) (every
    query shard's, which must agree), "fri_ok": (B,) (the AND over the
    query shards), "query_shards": (B, n_query) bool, each query shard's own
    verdict before the masks}.  A malformed shard raises ValueError before
    any shard is loaded.

    With a ``utils.profiling.SpanTimer`` (``timer.read()`` after the call),
    the call records host spans ``mesh.feed`` (from the call's entry until
    the last replay was issued), ``mesh.load.<k>`` (shard k's check,
    observed sequence, pack and copy), ``mesh.gather`` (from the last replay
    issued until the outputs are on the host) and ``mesh.call``; on a GPU
    the device span ``mesh.replay.<k>`` (CUDA events around shard k's graph
    replay, on its card's stream); and the counts ``mesh.shards``,
    ``mesh.pad_lanes`` and ``mesh.bytes_in`` (the bytes the shards' loads
    copy to the cards).  Shard k is (i, j) in row-major order: on a 1-D
    mesh of distinct cards, card k."""
    t0 = time.perf_counter()
    n_proof, n_query = mesh.shape["proof"], mesh.shape["query"]
    windows = [query_rounds(spec, (j, n_query)) for j in range(n_query)]
    padded, B = pad_batch(proof_batch, n_proof)
    per = padded["pow_witness"].shape[0] // n_proof
    qkeys = set(serde.query_axis_keys(spec))
    parts, entries = [], []
    for i in range(n_proof):
        lanes = _lanes(padded, i, n_proof)
        for j, (start, stop) in enumerate(windows):
            part = {k: (v[:, start:stop] if k in qkeys else v)
                    for k, v in lanes.items()}
            verifier.check_batch(spec, part, per, (j, n_query))
            parts.append(part)
            entries.append(_entry(spec, per, mesh.devices[i, j],
                                  (j, n_query)))
    feeds = ({e.device: mesh.feed(e.device) for e in entries}
             if _threaded(entries) else None)
    outs, issued = _feed(entries, parts, timer, feeds)
    host = [{k: v.cpu().numpy() for k, v in out.items()} for out in outs]
    gathered = time.perf_counter()

    def stacked(name):  # (B, n_query): shard (i, j)'s lanes in row i's block
        return np.stack(
            [np.concatenate([host[i * n_query + j][name]
                             for i in range(n_proof)])
             for j in range(n_query)], axis=-1)[:B]

    per_shard, plonk_ok, fri_ok = (stacked(name) for name in
                                   ("verdict", "plonk_ok", "fri_ok"))
    if (plonk_ok != plonk_ok[:, :1]).any():
        raise RuntimeError("query shards disagree on the PLONK check, "
                           "which each of them repeats whole")
    verdict = verifier.apply_valid_masks(per_shard.all(axis=-1), proof_batch,
                                         valid_mask)
    if timer is not None:
        timer.set("mesh.feed", issued - t0)
        timer.set("mesh.gather", gathered - issued)
        timer.set("mesh.shards", len(entries))
        timer.set("mesh.pad_lanes", per * n_proof - B)
        timer.set("mesh.bytes_in", sum(e.bytes_in for e in entries))
        timer.set("mesh.call", time.perf_counter() - t0)
    if diagnostics:
        return {"verdict": verdict, "plonk_ok": plonk_ok[:, 0],
                "fri_ok": fri_ok.all(axis=-1), "query_shards": per_shard}
    return verdict


class _Eager:
    """A CPU shard's load and replay, as a compiled verifier's: ``prepare``
    then the eager ``verify_device``."""

    bytes_in = 0  # nothing is copied to a card

    def __init__(self, spec, device, query_shard):
        self.spec, self.device, self.query_shard = spec, device, query_shard
        self.loaded = None

    def load(self, part, timer=None):
        self.loaded = verifier.prepare(self.spec, part, self.device, timer)

    def replay(self, timer=None):
        schedule, dev, obs = self.loaded
        return verifier.verify_device(self.spec, schedule, dev, obs,
                                      diagnostics=True, timer=timer,
                                      query_shard=self.query_shard)


def _entry(spec, batch_size, device, query_shard):
    """What runs a shard of ``batch_size`` lanes on ``device``: the compiled
    verifier of its key on a GPU, the eager verifier on the CPU."""
    if device.type == "cpu":
        return _Eager(spec, device, query_shard)
    return verifier.compiled_verifier(spec, batch_size, device,
                                      pb.kernel_impl(), query_shard)


def _threaded(entries):
    """Whether the feed threads take the call: every shard on a GPU, its
    key captured, so that no capture overlaps another thread's work."""
    return all(e.device.type == "cuda" and e.graph is not None
               for e in entries)


class _ShardTimer:
    """What shard k's entry sees of the mesh's timer: its device stages,
    as ``mesh.<name>.<k>``; its host stages are not kept (the mesh times
    the load itself, and a replay's issue is in ``mesh.feed``)."""

    def __init__(self, timer, k):
        self.timer, self.k = timer, k

    def stage(self, name):
        return contextlib.nullcontext()

    def device_stage(self, name, device):
        return self.timer.device_stage(f"mesh.{name}.{self.k}", device)


def _run_shards(shards, timer):
    """Load and replay each (k, entry, part) of ``shards`` in turn:
    [(k, outputs)], and when the last replay was issued."""
    from torch.profiler import record_function

    done = []
    for k, entry, part in shards:
        load_span = timer.stage(f"mesh.load.{k}") if timer else \
            contextlib.nullcontext()
        with load_span, record_function("mesh.load"):
            entry.load(part)
        done.append((k, entry.replay(timer and _ShardTimer(timer, k))))
    return done, time.perf_counter()


def _feed(entries, parts, timer=None, feeds=None):
    """Load and replay shard k's entry on ``parts[k]``, for every k: (each
    shard's outputs, not yet read; when the last replay was issued).

    Without ``feeds`` the calling thread runs the shards in order.  With
    ``feeds`` ({device: a one-thread executor}) each device's shards run in
    order on its executor, the devices side by side, and the call returns
    once every executor is done; an error in one is raised here after
    that, so no executor is left busy."""
    shards = list(zip(range(len(entries)), entries, parts))
    if feeds is None:
        done, issued = _run_shards(shards, timer)
    else:
        by_device = {}
        for shard in shards:
            by_device.setdefault(shard[1].device, []).append(shard)
        futures = [feeds[device].submit(_run_shards, group, timer)
                   for device, group in by_device.items()]
        concurrent.futures.wait(futures)
        results = [f.result() for f in futures]
        done = [d for group, _ in results for d in group]
        issued = max(t for _, t in results)
    outs = dict(done)
    return [outs[k] for k in range(len(entries))], issued
