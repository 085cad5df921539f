"""Host feed a call, ms: the stages observed + convert + copy_in of the
compiled verifier's load (the batch's check and observed sequence, the
pack into the pinned buffer, the copy), by the port's stage timer, mean over
the traced window's staged calls."""

from portbench.harness.readers import stage_ms


def read(run):
    return stage_ms(run, "observed", "convert", "copy_in")
