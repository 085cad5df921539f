"""Peak device memory the run reserved (torch.cuda.max_memory_reserved,
the compiled verifier's graph and pool held), MiB."""

from portbench.harness.readers import reserved_mib as read  # noqa: F401
