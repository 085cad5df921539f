"""The port's tiny spec and dummy proofs against the JAX package's: the spec
field by field, each proof array by array (values, dtypes, shapes), so the
mesh tests of both packages feed the verifier the same inputs.  Exact
comparisons: the arrays are integers."""
import dataclasses

import numpy as np
import pytest

from plonky2_tpu.proof import synthetic as jsyn
from plonky2_tpu_torch.proof import synthetic as syn


@pytest.mark.parametrize("rounds", [1, 4])
def test_tiny_spec_equals_jax(rounds):
    got, want = syn.make_tiny_spec(rounds), jsyn.make_tiny_spec(rounds)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.oracle_leaf_sizes == want.oracle_leaf_sizes
    assert got.step_tree_depths == want.step_tree_depths


@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dummy_proof_equals_jax(rounds, seed):
    got = syn.make_dummy_proof(syn.make_tiny_spec(rounds), seed)
    want = jsyn.make_dummy_proof(jsyn.make_tiny_spec(rounds), seed)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k
