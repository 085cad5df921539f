"""Device kernels a verify_batch call launches, counted by torch.profiler
over the profiled stretch (copies and sets not counted)."""

from portbench.harness.readers import kernels_per_call as read  # noqa: F401
