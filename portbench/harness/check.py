"""What decides ``correct``: every lane of every call in the window against
the plain reference (``reference/plain_verifier.py``).

The reference verifies each distinct proof of the plan once, from the raw
JSON that the system was handed, in worker processes once the window has
closed; each lane's expected answer is its proof's. A lane is wrong where
``verdict``, ``plonk_ok`` or ``fri_ok`` differs. The limit of each count is
0: the comparison is exact.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os

import numpy as np

OUTPUTS = ("verdict", "plonk_ok", "fri_ok")


def _verify_one(circuit_dir, raw, vraw, query_rounds):
    from portbench.reference import plain_verifier

    spec = plain_verifier.load_spec(os.path.join(circuit_dir,
                                                 "common_circuit_data.json"))
    return plain_verifier.verify(spec, raw, vraw, query_rounds)


def reference_answers(circuit_dir, plan, query_rounds=None, workers=8):
    """[{"verdict", "plonk_ok", "fri_ok"}] of each distinct proof of
    ``plan``, by the plain reference (checking the first ``query_rounds``
    FRI query rounds, all by default), in at most ``workers`` processes."""
    workers = max(1, min(workers, len(plan.proofs), os.cpu_count() or 1))
    context = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers,
                                                mp_context=context) as pool:
        futures = [pool.submit(_verify_one, str(circuit_dir), raw, plan.vraw,
                               query_rounds) for raw in plan.proofs]
        return [f.result() for f in futures]


def expected(plan, answers):
    """{output: (batches, B) bool} of what each lane of each batch must
    read."""
    return {k: np.array([[answers[p][k] for p in lanes]
                         for lanes in plan.batches], dtype=bool)
            for k in OUTPUTS}


def compare(calls, want):
    """``calls``: (batch index, {output: (B,) bool}) of each call. Returns
    ({check name: {"value": lanes wrong in that output, "limit": 0}},
    lanes in which any output is wrong)."""
    wrong = {k: 0 for k in OUTPUTS}
    any_wrong = 0
    for i, out in calls:
        diff = np.zeros(want["verdict"][i].shape, dtype=bool)
        for k in OUTPUTS:
            got = np.asarray(out[k], dtype=bool)
            d = (got != want[k][i] if got.shape == diff.shape
                 else np.ones_like(diff))
            wrong[k] += int(np.count_nonzero(d))
            diff |= d
        any_wrong += int(np.count_nonzero(diff))
    return ({f"{k}_lanes_wrong": {"value": wrong[k], "limit": 0}
             for k in OUTPUTS}, any_wrong)
