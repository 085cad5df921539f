"""Shared fixtures of the benchmark's CPU tests (``pytest portbench/tests``
from the repository's root; the tests marked ``cuda`` need a card and skip
without one)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _content(plan):
    """What tells one plan's proofs and batches from another's: each
    corrupted value at its site (all else is the fixture's)."""
    values = []
    for raw, site in zip(plan.proofs, plan.sites):
        node = raw
        for key in site or []:
            node = node[key]
        values.append((repr(site), repr(node) if site else None))
    return repr((values, plan.batches))


@pytest.fixture(scope="session")
def memo_reference():
    """``check.reference_answers`` memoised by plan and rounds, so a test
    that runs the reference in the system's place and then checks against
    it pays for it once."""
    from portbench.harness import check

    plain = check.reference_answers
    cache = {}

    def answers(circuit_dir, plan, query_rounds=None, workers=8):
        key = (str(circuit_dir), _content(plan), query_rounds)
        if key not in cache:
            cache[key] = plain(circuit_dir, plan, query_rounds, workers)
        return cache[key]

    return answers


@pytest.fixture
def cached_reference(monkeypatch, memo_reference):
    from portbench.harness import check

    monkeypatch.setattr(check, "reference_answers", memo_reference)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
