"""The seeded plan: the same seed gives the same inputs, seeds differ, every
seed the same sizes and kinds, and every corruption stays canonical and
ingests."""

import pytest

from portbench.harness import catalog, traffic

BIG_SEED = 2**31 + 982451653


def _plan(cell, seed):
    c = catalog.Catalog()
    cell = c.cell(cell)
    return traffic.make_plan(c.config(cell["config"])["circuit_dir"],
                             c.traffic(cell["traffic"]), seed)


def _values(plan):
    out = []
    for raw, site in zip(plan.proofs[1:], plan.sites[1:]):
        node = raw
        for key in site:
            node = node[key]
        out.append((site, node))
    return out


CELLS = ["step-b256", "decode_block-b4", "step-b64"]


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_plan(cell):
    a, b = _plan(cell, BIG_SEED), _plan(cell, BIG_SEED)
    assert a.batches == b.batches and _values(a) == _values(b)
    assert a.proofs == b.proofs


@pytest.mark.parametrize("cell", CELLS)
def test_seeds_differ_in_sites_not_in_sizes(cell):
    a, b = _plan(cell, 1), _plan(cell, BIG_SEED)
    assert _values(a) != _values(b)
    assert a.kinds == b.kinds
    count = [sum(1 for k in lanes if k) for lanes in a.batches]
    assert sorted(count) == sorted(sum(1 for k in lanes if k)
                                   for lanes in b.batches)
    assert len(a.batches[0]) == len(b.batches[0])


@pytest.mark.parametrize("cell", CELLS)
def test_every_invalid_proof_is_used(cell):
    plan = _plan(cell, 77)
    used = {k for lanes in plan.batches for k in lanes}
    assert used == set(range(len(plan.proofs)))


def test_corruption_leaves_the_fixture_alone():
    plan = _plan("decode_block-b4", 3)
    raw, _ = traffic.load_circuit(
        catalog.Catalog().config("decode_block")["circuit_dir"])
    assert plan.proofs[0] == raw
    assert all(p != raw for p in plan.proofs[1:])


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("cell", ["step-b256", "decode_block-b4"])
def test_corruptions_ingest_in_the_port(cell, seed):
    """Each corrupted proof ingests (every value canonical), so it reaches
    the verifier and is not masked at ingest."""
    from plonky2_tpu_torch.proof import serde
    from plonky2_tpu_torch.proof.spec import load_circuit_spec

    plan = _plan(cell, seed * 7919 + BIG_SEED)
    c = catalog.Catalog()
    d = c.config(c.cell(cell)["config"])["circuit_dir"]
    spec = load_circuit_spec(d / "common_circuit_data.json")
    for raw in plan.proofs:
        serde.ingest_proof(spec, raw, plan.vraw)
    for site, value in _values(plan):
        modulus = traffic.BN_P if "siblings" in site else traffic.GL_P
        assert 0 <= int(value) < modulus
