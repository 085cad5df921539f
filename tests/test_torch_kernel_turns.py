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
