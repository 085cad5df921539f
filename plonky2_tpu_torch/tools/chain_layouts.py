"""FRI's chain kernels under each layout they can take, timed on one GPU.

    python -m plonky2_tpu_torch.tools.chain_layouts

For each case of ``CASES`` (the step circuit at B = 256, 128 and 51 and
decode_block at B = 4, every query round, random canonical limbs from a
seed) and each form, runs the chain kernel (``kernels/fri_merkle.launch``)
under every layout of ``layouts``: kernel A's lane and pair forms, the
CIOS lane and group forms, a kind a slot type, and the lane forms also
with the kinds packed (``fri/merkle.slot_plan``).  Each is checked against
``fri/merkle.merkle_roots_plain`` bit for bit and timed in a CUDA graph of
``GRAPH_LAUNCHES`` launches, the best of 2 replays.  Prints one JSON line a
case and layout (``main`` marks the layout the main path takes,
``kernels/fri_merkle.geometry``), then the card's name and power limit.
This is how ``PAIR_LANES``, ``GROUP_LANES`` and the packing rule of
``kernels/fri_merkle.launch_geometry`` were set.  Exits 2 without a GPU,
1 if a layout's roots differ.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CASES = [("step", 256), ("step", 128), ("step", 51), ("decode_block", 4)]
GRAPH_LAUNCHES = 3
SEED = 90


def layouts(plan, form):
    """{name: (slot types, threads a lane)} of the layouts a launch of
    ``form`` (``a`` or ``cios``) can take."""
    from plonky2_tpu_torch.fri import merkle

    one, packed = merkle.slot_plan(plan), merkle.slot_plan(plan, pack=True)
    wide = ("pair", 2) if form == "a" else ("group", 4)
    return {"lane": (one, 1), "lane packed": (packed, 1),
            wide[0]: (one, wide[1])}


def graph_ms(fn):
    """One fn() in a CUDA graph of GRAPH_LAUNCHES calls: the best of 2
    replays, a launch."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = None
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / GRAPH_LAUNCHES
        best = ms if best is None else min(best, ms)
    return best


def main(argv=None):
    import torch

    if not torch.cuda.is_available():
        print("chain_layouts: needs a CUDA device", file=sys.stderr)
        return 2
    from plonky2_tpu_torch.fri import merkle
    from plonky2_tpu_torch.kernels import fri_merkle as kf
    from plonky2_tpu_torch.proof.spec import load_circuit_spec
    from plonky2_tpu_torch.tools.kernel_turns import chain_inputs

    dev = torch.device("cuda", 0)
    root = Path(__file__).resolve().parents[2]
    for fixture, B in CASES:
        spec = load_circuit_spec(root / "testdata" / fixture
                                 / "common_circuit_data.json")
        plan = merkle.merkle_plan(spec)
        d, x = chain_inputs(spec, B, SEED, dev)
        lanes = x[0].numel()
        want = merkle.merkle_roots_plain(plan, d, x)
        for form in ("a", "cios"):
            main_geo = kf.geometry(plan, lanes, form, dev)
            for name, (types, tpl) in layouts(plan, form).items():
                geo = kf.layout(form, types, tpl, lanes)
                got = kf.launch(geo, plan, d, x)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    print(f"chain_layouts: {fixture} B={B} {form} {name} "
                          f"differs from merkle_roots_plain", file=sys.stderr)
                    return 1
                lim = kf.limits(dev, geo.kernel, geo.threads)
                print(json.dumps({
                    "case": f"{fixture} B={B}", "chains": lanes * len(plan),
                    "form": form, "layout": name, "main": geo == main_geo,
                    "kernel": geo.kernel, "slot_types": len(types),
                    "threads_a_lane": tpl, "blocks": geo.blocks,
                    "resident_blocks_an_sm": lim["resident"],
                    "ms": graph_ms(lambda: kf.launch(geo, plan, d, x))}),
                    flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
