"""The mesh's slowest replay a call, ms: of the cards' ``mesh.replay.<k>``
(CUDA events around the graph's replay, on the card's stream) the largest,
mean over the traced window's staged calls."""

from portbench.harness.mesh_spans import per_call, replays


def _slowest(stages):
    seconds = replays(stages)
    return max(seconds) * 1e3 if seconds else None


def read(run):
    return per_call(run, _slowest)
