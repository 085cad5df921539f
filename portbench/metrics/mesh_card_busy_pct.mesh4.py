"""Share of a mesh call in which the cards replay their graphs, %: for
each staged call the mean over the cards of ``mesh.replay.<k>`` (CUDA
events) over ``mesh.call`` (host clock), mean over the traced window's
staged calls."""

from portbench.harness.mesh_spans import per_call, replays


def _busy(stages):
    seconds, call = replays(stages), stages.get("mesh.call")
    if not seconds or not call:
        return None
    return 100 * sum(seconds) / len(seconds) / call


def read(run):
    return per_call(run, _busy)
