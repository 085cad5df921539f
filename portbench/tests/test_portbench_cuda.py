"""On the card: one short run of each cell is correct and reports its
metrics (``pytest -m cuda portbench/tests/test_portbench_cuda.py``)."""

import json
import subprocess
import sys

import pytest

from portbench.harness import catalog


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [c["name"] for c in
                                  catalog.Catalog().bench["workloads"]])
def test_cell_runs_correct(card, cell, trace):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, cwd=catalog.ROOT, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    c = catalog.Catalog()
    want = {m["name"] for m in c.metrics(cell, bool(trace))}
    assert set(result["metrics"]) == want
