"""Arithmetic of the proof mesh's spans (``parallel/mesh.py``'s, through
the port's ``SpanTimer``), shared by the mesh's metric readers. Each
function returns None where a staged call lacks what it reads, as a
program without those spans gives."""

from __future__ import annotations

from .main import mean


def replays(stages):
    """Each shard's ``mesh.replay.<k>`` seconds of one staged call, or
    None where the call lacks ``mesh.shards`` or one of them."""
    n = stages.get("mesh.shards")
    names = [f"mesh.replay.{k}" for k in range(int(n or 0))]
    if not names or any(name not in stages for name in names):
        return None
    return [stages[name] for name in names]


def per_call(run, value):
    """The mean over the staged calls of ``value(stages)``, or None where
    there is none or a call gives None."""
    values = [value(stages) for stages in run.stages]
    if not values or any(v is None for v in values):
        return None
    return mean(values)
