"""``tools/kernel_turns``'s host side: the SASS digest keeps each kernel's
instructions apart and ignores addresses and encodings, the summary averages
each tree's turns and divides by tree 0, the trees take turns 0, 1, ..., k,
k, ..., 1, 0, and without a GPU the tool exits 2."""
import pytest

from plonky2_tpu_torch.tools import kernel_turns as kt

SASS = """
	code for sm_90a
		Function : _ZN50_GLOBAL__N__aaaa21poseidon_bn254_kernelEPKx
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;           /* 0x00000a00ff017b82 */
                                                                    /* 0x000fe20000000800 */
        /*0010*/                   IMAD R2, R3, R4, R5 ;            /* 0x0000000403027224 */
		Function : _ZN55_GLOBAL__N__bbbb26poseidon_bn254_cios_kernelEPKx
        /*0000*/                   LDC R1, c[0x0][0x28] ;           /* 0x00000a00ff017b82 */
        /*0010*/                   EXIT ;                           /* 0x000000000000794d */
"""


def test_sass_digests_split_kernels_and_ignore_addresses():
    got = kt.sass_digests(SASS)
    assert sorted(got) == ["poseidon_bn254", "poseidon_bn254_cios"]
    assert got["poseidon_bn254"][1] == 2 and got["poseidon_bn254_cios"][1] == 2
    assert got["poseidon_bn254"][0] != got["poseidon_bn254_cios"][0]
    moved = SASS.replace("/*0010*/", "/*0020*/").replace("aaaa", "cccc")
    moved = moved.replace("0x0000000403027224", "0x1111111111111111")
    assert kt.sass_digests(moved) == got


def test_sass_digests_join_the_functions_of_one_kernel():
    two = SASS + """
		Function : _ZN55_GLOBAL__N__bbbb31poseidon_bn254_cios_kernel_laneEPKx
        /*0000*/                   IMAD R2, R3, R4, R5 ;            /* 0x0000000403027224 */
"""
    got, one = kt.sass_digests(two), kt.sass_digests(SASS)
    assert got["poseidon_bn254_cios"][1] == 3
    assert got["poseidon_bn254_cios"][0] != one["poseidon_bn254_cios"][0]
    assert got["poseidon_bn254"] == one["poseidon_bn254"]


def test_summarize_averages_turns_and_divides_by_tree_0():
    runs = [{"tree": 0, "sass": {}, "ms": {"a": [1.0, 3.0]}},
            {"tree": 1, "sass": {}, "ms": {"a": [4.0]}},
            {"tree": 1, "sass": {}, "ms": {"a": [6.0]}},
            {"tree": 0, "sass": {}, "ms": {"a": [2.0]}}]
    got = kt.summarize(runs)
    assert got[0]["ms"] == {"a": 2.0} and got[1]["ms"] == {"a": 5.0}
    assert got[1]["over_tree_0"] == {"a": 2.5}


@pytest.mark.parametrize("n_trees, order", [
    (1, [0]), (2, [0, 1, 1, 0]), (3, [0, 1, 2, 2, 1, 0])])
def test_turn_order_puts_every_tree_on_both_sides(n_trees, order):
    assert kt.turn_order(n_trees) == order


def test_main_without_a_gpu_exits_2(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kt.main([]) == 2


def test_chain_calls_weigh_one_step_verification():
    calls = kt.chain_calls()
    assert sum(calls["qe_horner"].values()) == 8
    assert sum(calls["qe_powers"].values()) == 2
    assert calls["qe_horner"]["qe_horner@7168x32"] == 1
    assert calls["qe_horner"]["qe_horner@256x145"] == 2
    runs = [{"tree": 0, "sass": {},
             "ms": {"qe_horner@256x145": [1.0], "qe_horner@256x258": [3.0],
                    "qe_powers@256x258": [2.0], "qe_powers@7168x32": [5.0]}}]
    got = kt.summarize(runs)[0]["ms_one_verification"]
    assert got == {"qe_horner": 5.0, "qe_powers": 2.0}


def test_chain_calls_weigh_the_inverse_and_the_bit_selected_products():
    calls = kt.chain_calls()
    assert calls["qe_inv"] == {"qe_inv@256": 1, "qe_inv@256x28": 2,
                               "qe_inv@256x28x16": 4}
    assert sum(calls["gl_mul_const_bits"].values()) == 3
    runs = [{"tree": 0, "sass": {},
             "ms": {"qe_inv@256": [1.0], "qe_inv@256x28": [2.0],
                    "qe_inv@256x28x16": [3.0], "subgroup_x@256x28": [4.0],
                    "coset_start_0@256x28": [5.0],
                    "coset_start_1@256x28": [6.0]}}]
    got = kt.summarize(runs)[0]["ms_one_verification"]
    assert got == {"qe_inv": 17.0, "gl_mul_const_bits": 15.0}


def test_bits_table_matches_the_fri_loops():
    from plonky2_tpu_torch.fields import goldilocks as gl
    root = gl.primitive_root_of_unity(16)
    assert kt.bits_table(gl, "subgroup_x", 16) == gl.bitrev_powers(root, 16)
    g_inv = pow(gl.primitive_root_of_unity(4), 15, gl.P)
    assert kt.bits_table(gl, "coset_start_1", 4) == gl.bitrev_powers(g_inv, 4)


def test_scan_call_takes_each_trees_form_with_equal_outputs():
    """A tree whose ``coset_interp_scan`` takes the host schedule gets it; an
    earlier tree's (the chunks' starts, the gathered values and the
    schedule as tensors) gets those, made as its gate made them: the same
    outputs either way (here both run the plain scan on the CPU)."""
    import types

    import numpy as np
    import torch

    from plonky2_tpu_torch.fields import goldilocks as gl
    from plonky2_tpu_torch.fields import goldilocks_ext as qe
    from plonky2_tpu_torch.gates import gates as G

    gate = G.CosetInterpolationGate(4, 6, list(range(1, 17)))
    rng = np.random.default_rng(3)

    def ea(n):
        return tuple(tuple(tuple(t.reshape(4, n) for t in gl.split_u64(
            rng.integers(0, gl.P, size=(4, n), dtype=np.uint64)))
            for _ in range(2)) for _ in range(2))

    args = (ea(2), ea(2), ea(16), ea(1))
    new = kt.scan_call(G, gl, qe, gate, *args)()
    old_tree = types.SimpleNamespace(
        coset_interp_scan=G.coset_interp_scan_plain)
    old = kt.scan_call(old_tree, gl, qe, gate, *args)()
    leaves = torch.utils._pytree.tree_leaves
    assert len(leaves(new)) == len(leaves(old)) == 16
    assert all(torch.equal(a, b) for a, b in zip(leaves(new), leaves(old)))


def test_plain_turns_times_the_plain_permutation():
    """``tools/plain_turns`` on this tree alone at two lanes: one process,
    a median a lane count (the turns across trees are ``turn_order``'s)."""
    import json
    import subprocess
    import sys

    from plonky2_tpu_torch.tools import plain_turns as pt

    out = subprocess.run(
        [sys.executable, "-m", "plonky2_tpu_torch.tools.plain_turns",
         "--lanes", "2", "--reps", "1"],
        cwd=pt.REPO, capture_output=True, text=True, check=True)
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [r["tree"] for r in lines[:-1]] == [0]
    summary = lines[-1]["per_tree"]
    assert list(summary) == ["0"] and set(summary["0"]["median_s"]) == {"2"}
    assert summary["0"]["tree_0_over_this"] == {"2": 1.0}


def test_plain_turns_summary_takes_medians():
    from plonky2_tpu_torch.tools import plain_turns as pt

    runs = [{"tree": 0, "seconds": {"8": [3.0, 1.0]}},
            {"tree": 1, "seconds": {"8": [1.0]}},
            {"tree": 1, "seconds": {"8": [2.0]}},
            {"tree": 0, "seconds": {"8": [2.0]}}]
    got = pt.summarize(runs)
    assert got[0]["median_s"] == {"8": 2.0}
    assert got[1]["median_s"] == {"8": 2.0}
    assert got[1]["tree_0_over_this"] == {"8": 1.0}
