"""Gate parity: the port's gate evaluators against the golden constraint
outputs of testdata/gates_golden.json (11 gates, as test_gates.py uses
them), and the port's whole ``evaluate_gate_constraints`` on both fixtures'
openings against the JAX package's independent Python-int evaluator
``bench.cpu_reference._eval_gates_ref``.  Between them the two fixtures use
all 14 gate types.  Values are field elements compared exactly: no
tolerance applies."""
import json

import numpy as np
import pytest
import torch

from plonky2_tpu.bench import cpu_reference as R
from plonky2_tpu.proof.spec import load_circuit_spec as jload_spec
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.gates import gates as G
from plonky2_tpu_torch.proof.spec import load_circuit_spec

torch.set_num_threads(1)
NUM_SELECTORS = 3


def qe_pack(pairs):
    """[[c0, c1], ...] -> QE tensor pair of shape (1, n)."""
    arr = np.asarray([[int(a) for a, _ in pairs], [int(b) for _, b in pairs]],
                     dtype=np.uint64)
    return (gl.split_u64(arr[0][None]), gl.split_u64(arr[1][None]))


def qe_unpack(x, lane=0):
    c0, c1 = gl.join_u64(x[0])[lane], gl.join_u64(x[1])[lane]
    return [[int(a), int(b)] for a, b in zip(c0, c1)]


COSET_WEIGHTS = [17293822565076172801, 18374686475376656385,
                 18446744069413535745, 281474976645120, 17592186044416,
                 18446744069414584577, 18446744000695107601,
                 18446744065119617025, 1152921504338411520, 72057594037927936,
                 18446744069415632897, 18446462594437939201,
                 18446726477228539905, 18446744069414584065, 68719476720,
                 4294967296]

CASES = [
    (G.PublicInputGate(), "publicInputGateExpectedConstraints"),
    (G.BaseSumGate(63, 2), "baseSumGateExpectedConstraints"),
    (G.ArithmeticGate(20), "arithmeticGateExpectedConstraints"),
    (G.RandomAccessGate(4, 4, 2), "randomAccessGateExpectedConstraints"),
    (G.PoseidonGate(), "poseidonGateExpectedConstraints"),
    (G.ArithmeticExtensionGate(10), "arithmeticExtensionGateExpectedConstraints"),
    (G.MulExtensionGate(13), "mulExtensionGateExpectedConstraints"),
    (G.ReducingExtensionGate(33), "reducingExtensionGateExpectedConstraints"),
    (G.ReducingGate(44), "reducingGateExpectedConstraints"),
    (G.CosetInterpolationGate(4, 6, COSET_WEIGHTS),
     "cosetInterpolationGateExpectedConstraints"),
    (G.PoseidonMdsGate(), "poseidonMdsGateExpectedConstraints"),
]


@pytest.fixture(scope="module")
def golden():
    with open("testdata/gates_golden.json") as f:
        return json.load(f)


@pytest.mark.parametrize("gate,key", CASES, ids=[k for _, k in CASES])
def test_gate_golden(golden, gate, key):
    consts = qe_pack(golden["localConstants"][NUM_SELECTORS:])
    wires = qe_pack(golden["localWires"])
    pih = gl.zeros((1, 4))
    got = qe_unpack(gate.eval(consts, wires, pih))
    assert got == golden[key]


@pytest.mark.parametrize("name", ["step", "decode_block"])
def test_evaluate_gate_constraints_matches_cpu_reference(name):
    path = f"testdata/{name}/common_circuit_data.json"
    spec, jspec = load_circuit_spec(path), jload_spec(path)
    with open(f"testdata/{name}/proof_with_public_inputs.json") as f:
        raw = json.load(f)
    op = raw["proof"]["openings"]
    consts = [(int(a), int(b)) for a, b in op["constants"]]
    wires = [(int(a), int(b)) for a, b in op["wires"]]
    pi_hash = R.hash_no_pad([int(x) for x in raw["public_inputs"]])

    want = R._eval_gates_ref(jspec, consts, wires, pi_hash)
    got = G.evaluate_gate_constraints(
        spec.gates(), spec.selector_indices, spec.groups,
        spec.num_gate_constraints, qe_pack(consts), qe_pack(wires),
        gl.split_u64(np.asarray([pi_hash], dtype=np.uint64)))
    assert qe_unpack(got) == [list(c) for c in want]
