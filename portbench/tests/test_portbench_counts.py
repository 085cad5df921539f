"""The work counts behind fri_merkle_roofline_pct against the records."""

import pytest

from portbench.harness import catalog, counts
from portbench.reference.plain_verifier import load_spec


def _spec(name):
    return load_spec(catalog.BENCH_DIR / "circuits" / name
                     / "common_circuit_data.json")


def test_permutations():
    assert counts.bn254_permutations(_spec("step"), 256) == 709_632
    assert counts.bn254_permutations(_spec("step"), 1) == 2_772
    assert counts.bn254_permutations(_spec("decode_block"), 4) == 10_416


def test_bound_at_step_b256():
    """3.84 ms: the tensor-core form's IMADs at 132 SMs x 64 a clock x
    1980 MHz (the int8 products and the bytes take less)."""
    spec, peaks = _spec("step"), counts.PEAKS["NVIDIA H100 80GB HBM3"]
    perms = counts.bn254_permutations(spec, 256)
    bound = counts.bn254_bound_s(perms, counts.merkle_bytes(spec, 256), peaks)
    assert bound * 1e3 == pytest.approx(3.8392, abs=5e-4)
    assert counts.merkle_bytes(spec, 256) / peaks["hbm_bytes_per_s"] < bound
    assert counts.imad_per_s(peaks) == pytest.approx(1.6727e13, rel=1e-4)
