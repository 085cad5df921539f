"""The mesh's host feed a call, ms: the span ``mesh.feed`` of the port's
``SpanTimer``, from the call's entry until the last card's replay was
issued (every shard's check, then each card's load, side by side on the
mesh's feed threads), mean over the traced window's staged calls."""

from portbench.harness.readers import stage_ms


def read(run):
    return stage_ms(run, "mesh.feed")
