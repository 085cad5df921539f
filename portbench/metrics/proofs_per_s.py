"""Proofs verified a second: the lanes of every call of the window over
the window's seconds (host clock, first call's start to last call's end)."""

from portbench.harness.readers import proofs_per_s as read  # noqa: F401
