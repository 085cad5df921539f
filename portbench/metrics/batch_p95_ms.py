"""95th percentile, by nearest rank over every call of the window, of
the host time from handing a batch to verify_batch to its verdicts on the
host, ms."""

from portbench.harness.readers import latency_p95_ms as read  # noqa: F401
