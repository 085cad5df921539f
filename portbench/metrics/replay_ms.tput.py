"""The compiled graph's replay a call, ms: the stage replay of the
port's stage timer, mean over the traced window's staged calls."""

from portbench.harness.readers import stage_ms


def read(run):
    return stage_ms(run, "replay")
