"""Share of the traced run's steady profiled stretch in which nothing ran
on the card, %: one minus the union of the device's kernel, copy and set
intervals over the stretch's length, both on the trace's own clock
(harness/trace.py; harness/readers.py: idle_pct). The profiler's own cost
on the host (a longer graph launch, its buffer flushes) counts as idle."""

from portbench.harness.readers import idle_pct as read  # noqa: F401
