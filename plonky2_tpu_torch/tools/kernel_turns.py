"""The hand-written kernels of two source trees, timed in turns on one GPU.

    python -m plonky2_tpu_torch.tools.kernel_turns [--tree DIR]...

Tree 0 is this checkout; each ``--tree`` adds the root of another checkout
of the repository (for example ``git archive`` of an earlier commit unpacked
under ``build/``), trees 1, 2, ...  For each tree in the order 0, 1, ..., k,
k, ..., 1, 0 (so that a drift of the card over the run falls on all; tree 0
alone without ``--tree``) one process runs from that tree's root with that
tree's ``plonky2_tpu_torch`` on its path.  It builds the tree's kernels;
checks kernel A and the CIOS kernel bit-exact against the plain
Poseidon-BN254 at each lane count the main path launches them at (7168: a
leaf-scan step or FRI layer of a step batch of 256; 28672: a Merkle level of
four oracles at once); times them at each, in turns A, CIOS, CIOS, A, and
the transcript kernel at B=256 on the step schedule, each over 20 launches
by CUDA events after a warm-up; times the QE Horner and powers kernels
(``csrc/goldilocks_ext.cu``) at each of their calls in a step verification
at B=256 and powers also at 7168 x 32, the QE inverse at its three call
shapes, and the product by a constant (``csrc/goldilocks_mul.cu``) at its
plain form's largest call and at FRI's three bit-selected calls (subgroup_x
and each round's cosetStart: one launch of ``goldilocks.mul_const_bits``
where the tree has it, else the loop of a product by a constant and a select
a bit that it replaced), and the interpolation gate's scan on the step
fixture's gate at 256 lanes (3 chunks of 6 steps; ``coset_interp_scan``
with the gate's host schedule where the tree has it, else with the
tensors the gate gathered for it before), each in a CUDA graph of 20 calls
(the mean of 3 replays), since one launch takes a few microseconds; times
FRI's two chain kernels (``kernels/fri_merkle.chains_a`` and
``chains_cios``, ``csrc/fri_merkle.cu``) on random canonical limbs in the
step circuit's layout at B=256 and the decode_block circuit's at B=4
(every query round), in turns A, CIOS, CIOS, A, each in a CUDA graph of
``CHAIN_ITERS`` calls (the mean of 3 replays), after checking each against
``fri/merkle.merkle_roots_plain`` bit for bit; digests each kernel's
SASS (``cuobjdump -sass``; equal digests mean the same machine code), the
transcript's output and the chains' and products' outputs; and keeps
``ptxas -v``'s lines of the build.  The same seed gives every process the
same inputs, so the transcript, chain and product outputs of all processes
must be equal.  A tree without the chain kernels times neither, and its
roots are left out of that check.

Prints one JSON line per process, then a summary: per tree, each kernel's
mean time (keys ``name@lanes`` for the BN254 kernels, ``name@lanesxn`` for
the chains, ``qe_inv@shape`` and ``name@shape`` for the products,
``merkle_chains_{a,cios}@{fixture}xB`` for FRI's chain kernels), SASS
digest and instruction count, the sum over one step verification's calls,
and its time over tree 0's, with the card's name and power limit.
Exits 1 if a check fails.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
BN_LANES = (7168, 28672)
TRANSCRIPT_BATCH = 256
ITERS = 20
SEED = 2024
# The chains' calls in a step verification at B=256 (chip_smoke.CHAIN_CALLS):
# Horner's (terms, x) shapes and powers' (lanes, n), each with its calls a
# verification; and powers at the final polynomial's 7168 x 32, on no path.
HORNER_SHAPES = [((256, 63), (), 1), ((256, 4, 4), (), 1),
                 ((256, 145), (256,), 2), ((256, 2, 8), (256, 1), 1),
                 ((256, 258), (256,), 1), ((256, 2), (256,), 1),
                 ((256, 1, 32), (256, 28), 1)]
POWERS_SHAPES = [(256, 258, 1), (256, 2, 1), (7168, 32, 0)]
# The QE inverse's calls in a step verification at B=256 (chip_smoke
# .INV_CALLS), each with its calls a verification.
INV_SHAPES = [((256,), 1), ((256, 28), 2), ((256, 28, 16), 4)]
# FRI's bit-selected products at step B=256 (256 x 28 query indices of 16
# bits; arity bits [4, 4]): (name, a given, c, off, bits), a call each.
LDE_BITS = 16
BITS_CALLS = [("subgroup_x", False, 7, 0, LDE_BITS),
              ("coset_start_0", True, 1, 0, 4),
              ("coset_start_1", True, 1, 4, 4)]
# The plain product by a constant at its largest call, (256, 44) by DTH_ROOT.
CONST_SHAPE = (256, 44)
# The interpolation scan's lanes: a step batch's.
SCAN_LANES = 256
# FRI's chain kernels: (fixture, B) at every query round of the circuit, and
# the calls a graph holds (a step batch's launch takes some 10 ms).
CHAIN_CASES = [("step", 256), ("decode_block", 4)]
CHAIN_ITERS = 5
# kernel key -> a substring of its mangled name only it has
KERNELS = {"poseidon_bn254": "poseidon_bn254_kernel",
           "poseidon_bn254_cios": "poseidon_bn254_cios_kernel",
           "poseidon_gl_transcript": "transcript_kernel",
           "qe_horner": "qe_horner_kernel",
           "qe_powers": "qe_powers_kernel",
           "qe_inv": "qe_inv_kernel",
           "gl_mul_const": "gl_mul_const_kernel",
           "coset_interp_scan": "coset_interp_scan_kernel",
           "merkle_chains_a": "merkle_chains_a_kernel",
           "merkle_chains_cios": "merkle_chains_cios_kernel"}
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def sass_digests(text):
    """{kernel key: (sha256 of its instructions, instruction count)} from
    ``cuobjdump -sass``'s output; addresses and encodings are left out.  A
    key whose needle names several functions (the CIOS kernel's group and
    lane kernels) digests all of them in the order of the listing."""
    found, name, insns = {}, None, []

    def close():
        for key, needle in KERNELS.items():
            if name and needle in name:
                found.setdefault(key, []).extend(insns)

    for line in text.splitlines():
        if "Function :" in line:
            close()
            name, insns = line.split("Function :", 1)[1].strip(), []
        elif name:
            m = _INSN.search(line)
            if m:
                insns.append(" ".join(m.group(1).split()))
    close()
    return {key: (hashlib.sha256("\n".join(v).encode()).hexdigest()[:16],
                  len(v)) for key, v in found.items()}


def summarize(runs):
    """Per tree: mean ms of each kernel, its SASS digest and count, and its
    time over tree 0's."""
    trees = {}
    for run in runs:
        t = trees.setdefault(run["tree"], {"ms": {}, "sass": run["sass"]})
        for key, ms in run["ms"].items():
            t["ms"].setdefault(key, []).extend(ms)
    for t in trees.values():
        t["ms"] = {k: sum(v) / len(v) for k, v in t["ms"].items()}
        t["ms_one_verification"] = {
            name: sum(t["ms"][key] * calls for key, calls in keys.items()
                      if key in t["ms"])
            for name, keys in chain_calls().items()
            if any(key in t["ms"] for key in keys)}
    base = trees[min(trees)]["ms"]
    for t in trees.values():
        t["over_tree_0"] = {k: v / base[k] for k, v in t["ms"].items()}
    return trees


def horner_key(t_shape, x_shape):
    """The timing key of a Horner call: ``qe_horner@{lanes}x{n}``."""
    lanes = math.prod(np.broadcast_shapes(t_shape[:-1], x_shape))
    return f"qe_horner@{lanes}x{t_shape[-1]}"


def chain_calls():
    """{kernel: {timing key: calls in one step verification}} of the chains."""
    horner = {}
    for t_shape, x_shape, calls in HORNER_SHAPES:
        key = horner_key(t_shape, x_shape)
        horner[key] = horner.get(key, 0) + calls
    return {"qe_horner": horner,
            "qe_powers": {f"qe_powers@{lanes}x{n}": calls
                          for lanes, n, calls in POWERS_SHAPES},
            "qe_inv": {inv_key(shape): calls for shape, calls in INV_SHAPES},
            "gl_mul_const_bits": {f"{name}@256x28": 1
                                  for name, *_ in BITS_CALLS}}


def inv_key(shape):
    """The timing key of an inverse call: ``qe_inv@256x28x16``."""
    return "qe_inv@" + "x".join(map(str, shape))


def bits_table(gl, name, n):
    """The constants of a BITS_CALLS call (``fri/verify.py``): the root of
    unity of order 2^n (subgroup_x) or its inverse (cosetStart) to the powers
    2^(n-1-i), i < n."""
    base = gl.primitive_root_of_unity(n)
    if name != "subgroup_x":
        base = pow(base, (1 << n) - 1, gl.P)
    return [pow(base, 1 << (n - 1 - i), gl.P) for i in range(n)]


def bits_call(gl, a, c, idx, bits, off, table):
    """FRI's bit-selected product in the tree's own form: one launch of
    ``mul_const_bits`` where the tree has it, else the loop it replaced (a
    product by a constant and a select a bit, on ``bits`` made before)."""
    import torch

    if hasattr(gl, "mul_const_bits"):
        return lambda: gl.mul_const_bits(a, c, idx, off, table)

    def loop():
        prod = (torch.ones_like(bits[0]), torch.zeros_like(bits[0]))
        for i in reversed(range(len(table))):
            prod = gl.select(bits[off + i].bool(),
                             gl.mul_const(prod, table[i]), prod)
        if a is not None:
            prod = gl.mul(prod, a)
        return gl.mul_const(prod, c)
    return loop


def scan_call(G, gl, qe, gate, inter_eval, inter_prod, values, pt):
    """The interpolation scan in the tree's own form: ``coset_interp_scan``
    with the gate's host schedule where it takes one, else with the chunks'
    starts, the gathered values and the schedule as tensors, made here, as
    the gate made them before the call."""
    import inspect

    if "schedule" in inspect.signature(G.coset_interp_scan).parameters:
        return lambda: G.coset_interp_scan(inter_eval, inter_prod, values, pt,
                                           gate.schedule)
    xs, ws, vidx, active = gate.schedule
    like = values[0][0][0]
    B = like.shape[0]
    z1, o1 = qe.zeros((B, 1), like.device), qe.ones((B, 1), like.device)
    ev = (qe.concat([z1, inter_eval[0]]), qe.concat([z1, inter_eval[1]]))
    pr = (qe.concat([o1, inter_prod[0]]), qe.concat([z1, inter_prod[1]]))
    vidx_t = gl.device_table(vidx, like.device)
    val = (qe.index(values[0], (Ellipsis, vidx_t)),
           qe.index(values[1], (Ellipsis, vidx_t)))
    args = (ev, pr, val, pt, gl.const_like(xs, like), gl.const_like(ws, like),
            gl.device_table(active, like.device))
    return lambda: G.coset_interp_scan(*args)


def chain_inputs(spec, B, seed, dev):
    """Random canonical limbs (below 2^253) in ``spec``'s leaf and sibling
    layout and random query indices below 2^lde_bits, B proofs of every
    query round: (tensor dict, index pair)."""
    import torch

    from plonky2_tpu_torch.proof import serde

    rng = np.random.default_rng(seed)
    d = {}
    for k, (shape, _) in serde.proof_shapes(spec).items():
        if k.endswith(("leaf_packed", "siblings")):
            v = rng.integers(0, 1 << 16, size=(B,) + shape, dtype=np.int64)
            v[..., 15] &= 0x1FFF
            d[k] = torch.as_tensor(v).to(dev)
    v = rng.integers(0, 1 << spec.lde_bits, size=(B, spec.num_query_rounds),
                     dtype=np.uint64)
    return d, (torch.as_tensor((v & 0xFFFFFFFF).astype(np.int64)).to(dev),
               torch.as_tensor((v >> 32).astype(np.int64)).to(dev))


def time_chains(dev, graph_ms):
    """{key: [ms, ms]} of FRI's two chain kernels at CHAIN_CASES in turns A,
    CIOS, CIOS, A, each checked against merkle_roots_plain; and the roots'
    bytes.  Empty where the tree has no chain kernel."""
    import torch

    try:
        from plonky2_tpu_torch.fri import merkle
        from plonky2_tpu_torch.kernels import fri_merkle as kf
    except ImportError:
        return {}, b""
    from plonky2_tpu_torch.proof.spec import load_circuit_spec

    ms, roots = {}, []
    for fixture, B in CHAIN_CASES:
        spec = load_circuit_spec(Path.cwd() / "testdata" / fixture
                                 / "common_circuit_data.json")
        plan = merkle.merkle_plan(spec)
        d, x = chain_inputs(spec, B, SEED + B, dev)
        want = merkle.merkle_roots_plain(plan, d, x)
        for form in ("a", "cios", "cios", "a"):
            fn = getattr(kf, f"chains_{form}")
            got = fn(plan, d, x)
            if not torch.equal(got, want):
                raise AssertionError(f"merkle_chains_{form} differs from "
                                     f"merkle_roots_plain on {fixture} B={B}")
            ms.setdefault(f"merkle_chains_{form}@{fixture}x{B}", []).append(
                graph_ms(lambda: fn(plan, d, x), CHAIN_ITERS))
        roots.append(want.cpu().numpy().tobytes())
    return ms, b"".join(roots)


def turn_order(n_trees):
    """Trees in the order 0, 1, ..., k, k, ..., 1, 0; tree 0 once alone."""
    up = list(range(n_trees))
    return up if n_trees == 1 else up + up[::-1]


def _child():
    import torch

    from plonky2_tpu_torch.fields import bn254
    from plonky2_tpu_torch.fields import goldilocks as gl
    from plonky2_tpu_torch.fields import goldilocks_ext as qe
    from plonky2_tpu_torch.gates import gates as G
    from plonky2_tpu_torch.kernels import build
    from plonky2_tpu_torch.kernels import goldilocks_ext as kq
    from plonky2_tpu_torch.kernels import poseidon_bn254 as kb
    from plonky2_tpu_torch.kernels import poseidon_bn254_cios as kc
    from plonky2_tpu_torch.kernels import poseidon_gl_transcript as kt
    from plonky2_tpu_torch.proof.fixtures import load_fixture
    from plonky2_tpu_torch.transcript import challenger as chal

    dev = torch.device("cuda", 0)
    build.library()
    rng = np.random.default_rng(SEED)

    def cuda_ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / ITERS

    def graph_ms(fn, iters=ITERS):
        """One fn() in a CUDA graph of ``iters`` calls, the mean of 3
        replays."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (3 * iters)

    def qe_vals(shape):
        return tuple(tuple(t.reshape(shape) for t in gl.split_u64(
            rng.integers(0, gl.P, size=shape, dtype=np.uint64), dev))
            for _ in range(2))

    ms = {}
    for lanes in BN_LANES:
        vals = rng.integers(0, 1 << 16, size=(lanes, 4, 16), dtype=np.int64)
        vals[..., 15] &= 0x1FFF  # < 2^253 < p
        vals[0] = np.asarray([bn254.int_to_limbs(v) for v in
                              (0, 1, bn254.P - 1, 2)], dtype=np.int64)
        st = torch.as_tensor(vals).to(dev)
        want = kb.permute_plain(st)
        for key, mod in (("poseidon_bn254", kb), ("poseidon_bn254_cios", kc)):
            if not torch.equal(mod.permute(st), want):
                raise AssertionError(f"{key} differs from the plain version "
                                     f"at {lanes} lanes")
        for key, mod in (("poseidon_bn254", kb), ("poseidon_bn254_cios", kc),
                         ("poseidon_bn254_cios", kc), ("poseidon_bn254", kb)):
            ms.setdefault(f"{key}@{lanes}", []).append(
                cuda_ms(lambda: mod.permute(st)))

    spec = load_fixture(Path.cwd() / "testdata" / "step")[0]  # the tree's
    schedule = chal.build_schedule(spec)
    obs = gl.split_u64(rng.integers(0, gl.P, size=(
        TRANSCRIPT_BATCH, schedule.n_obs), dtype=np.uint64), dev)
    pi = gl.split_u64(rng.integers(0, gl.P, size=(TRANSCRIPT_BATCH, 4),
                                   dtype=np.uint64), dev)
    states = kt.run_transcript_kernel(schedule, obs, pi)
    digest = hashlib.sha256(b"".join(
        t.cpu().numpy().tobytes() for t in states)).hexdigest()[:16]
    ms["poseidon_gl_transcript"] = [
        cuda_ms(lambda: kt.run_transcript_kernel(schedule, obs, pi))]

    chain_out = []
    for t_shape, x_shape, _ in HORNER_SHAPES:
        terms, x = qe_vals(t_shape), qe_vals(x_shape)
        chain_out.append(kq.horner(terms, x))
        ms[horner_key(t_shape, x_shape)] = [
            graph_ms(lambda: kq.horner(terms, x))]
    for lanes, n, _ in POWERS_SHAPES:
        x = qe_vals((lanes,))
        chain_out.append(kq.powers(x, n))
        ms[f"qe_powers@{lanes}x{n}"] = [graph_ms(lambda: kq.powers(x, n))]
    chain_digest = hashlib.sha256(b"".join(
        t.cpu().numpy().tobytes() for out in chain_out for c in out
        for t in c)).hexdigest()[:16]

    prod_out = []
    for shape, _ in INV_SHAPES:
        a = qe_vals(shape)
        prod_out.append(kq.inv(a))
        ms[inv_key(shape)] = [graph_ms(lambda: kq.inv(a))]
    idx = gl.split_u64(rng.integers(0, 1 << LDE_BITS, size=(256, 28),
                                    dtype=np.uint64), dev)
    bits = gl.to_bits(idx, 64)
    x = qe_vals((256, 28))[0]
    for name, has_a, c, off, n in BITS_CALLS:
        fn = bits_call(gl, x if has_a else None, c, idx, bits, off,
                       bits_table(gl, name, n))
        prod_out.append(fn())
        ms[f"{name}@256x28"] = [graph_ms(fn)]
    a44 = qe_vals(CONST_SHAPE)[0]
    prod_out.append(gl.mul_const(a44, gl.DTH_ROOT))
    ms["gl_mul_const@256x44"] = [graph_ms(
        lambda: gl.mul_const(a44, gl.DTH_ROOT))]
    gate, = [g for g in spec.gates() if isinstance(g, G.CosetInterpolationGate)]
    ni, chunks = gate.num_intermediates, 1 + gate.num_intermediates
    ea = [(qe_vals((SCAN_LANES, n)), qe_vals((SCAN_LANES, n)))
          for n in (ni, ni, gate.num_points, 1)]
    fn = scan_call(G, gl, qe, gate, *ea)
    prod_out.append(fn())
    ms[f"coset_interp_scan@{SCAN_LANES}x{chunks}x{gate.degree}"] = [
        graph_ms(fn)]
    prod_digest = hashlib.sha256(b"".join(
        t.cpu().numpy().tobytes()
        for t in torch.utils._pytree.tree_leaves(prod_out))).hexdigest()[:16]
    chain_ms, roots = time_chains(dev, graph_ms)
    ms.update(chain_ms)

    cuobjdump = (shutil.which("cuobjdump")
                 or "/usr/local/cuda/bin/cuobjdump")
    lib = build.BUILD_DIR / build.LIB_NAME
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    ptxas = [line.strip() for line in build.ptxas_log().splitlines()
             if "registers" in line or "spill" in line or "==" in line]
    print(json.dumps({"ms": ms, "transcript_digest": digest,
                      "chain_digest": chain_digest,
                      "product_digest": prod_digest,
                      "roots_digest": (hashlib.sha256(roots).hexdigest()[:16]
                                       if roots else None),
                      "sass": sass_digests(sass), "ptxas": ptxas}))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plonky2_tpu_torch.tools.kernel_turns")
    ap.add_argument("--tree", action="append", default=[],
                    help="root of another checkout (trees 1, 2, ...)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child()
        return 0

    import torch
    if not torch.cuda.is_available():
        print("kernel_turns: needs a CUDA device", file=sys.stderr)
        return 2
    trees = [REPO] + [Path(t).resolve() for t in args.tree]
    order = turn_order(len(trees))
    runs = []
    for i in order:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child"],
            cwd=trees[i], env={**os.environ, "PYTHONPATH": str(trees[i])},
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"kernel_turns: tree {i} ({trees[i]}) failed:\n"
                  f"{proc.stderr[-4000:]}", file=sys.stderr)
            return 1
        run = {"tree": i, **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(run))
        runs.append(run)
    for key in ("transcript_digest", "chain_digest", "product_digest",
                "roots_digest"):
        digests = {run[key] for run in runs if run[key] is not None}
        if len(digests) > 1:
            print(f"kernel_turns: the outputs differ ({key}): {digests}",
                  file=sys.stderr)
            return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    summary = {"card": card, "trees": [str(t) for t in trees], "order": order,
               "per_tree": summarize(runs)}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
