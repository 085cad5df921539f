"""Device time a call in FRI's Merkle chain kernel (names holding one
of PATTERNS), ms, from torch.profiler over the profiled stretch."""

from portbench.harness.readers import kernel_s_per_call

PATTERNS = ("merkle_chains",)


def read(run):
    seconds = kernel_s_per_call(run, PATTERNS)
    return None if seconds is None else seconds * 1e3
