"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (``plonky2_tpu_torch`` begins with ``plonky2_tpu``),
and the plain reference loads nothing of the port."""

import ast
import json
import subprocess
import sys

import pytest

from portbench.harness import catalog, main

HARNESS = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.harness import (catalog, check, control, counts, main,
                               readers, trace, traffic)
from portbench.reference import plain_verifier
import torch.profiler
from plonky2_tpu_torch import verifier
from plonky2_tpu_torch.proof import serde, spec
from plonky2_tpu_torch.utils import profiling
c = catalog.Catalog()
for group in ("end_to_end", "per_layer"):
    for m in c.bench[group]:
        c.reader(m["name"])
for cell in c.bench["workloads"]:
    mix = c.traffic(cell["traffic"])
    c.loop(mix["loop"])
    c.system(mix["system"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.reference import plain_verifier
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(code):
    out = subprocess.run([sys.executable, "-c",
                          code.format(root=str(catalog.ROOT))],
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    loaded = _loaded(HARNESS)
    assert "plonky2_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & set(main.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded(REFERENCE)
    assert not loaded & ({"plonky2_tpu_torch", "torch"} | set(main.FORBIDDEN))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in catalog.BENCH_DIR.rglob("*.py")
                 if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(catalog.BENCH_DIR)))
def test_sources_import_no_jax(path):
    names = set(_imports(path))
    assert not names & set(main.FORBIDDEN)
    if "reference" in path.parts:
        assert not names & {"plonky2_tpu_torch", "torch", "numpy"}
