"""Smoke run of the PyTorch + CUDA verifier (plonky2_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. requires a CUDA device and prints its name and power limit;
2. builds the hand-written kernels from plonky2_tpu_torch/csrc (nvcc);
3. checks each kernel bit-exact against its plain torch version on the card,
   at the main path's shapes, and times both;
4. verifies 256 copies of testdata/step with one corrupted lane (only that
   lane may be rejected), twice: the first call pays one-time costs, the
   second is the wall time per batch it reports;
5. verifies the decode_block batch [valid, bad opening, bad leaf, bad pow]
   (must give [True, False, False, False]);
6. checks that both kernels were launched by steps 4 and 5.

Every phase must pass or the script exits non-zero.  The last line of
stdout is a JSON object with the device; the line before it lists the
kernels with their launches, errors and times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from plonky2_tpu_torch import verifier
from plonky2_tpu_torch.fields import bn254
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.kernels import build
from plonky2_tpu_torch.kernels import poseidon_bn254 as kb
from plonky2_tpu_torch.kernels import poseidon_gl_transcript as kt
from plonky2_tpu_torch.proof import serde
from plonky2_tpu_torch.proof.fixtures import (corrupt_wires_opening,
                                              decode_block_lanes, load_fixture)
from plonky2_tpu_torch.transcript import challenger as chal

TESTDATA = Path(__file__).resolve().parent / "testdata"
STEP_BATCH = 256
CORRUPT_LANE = 1


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters):
    """Mean device time of fn() over iters launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_bn_states(n, rng):
    """(n, 4, 16) canonical Montgomery limbs; lane 0 holds 0, 1, p-1, 2."""
    vals = rng.integers(0, 1 << 16, size=(n, 4, 16), dtype=np.int64)
    vals[..., 15] &= 0x1FFF  # < 2^253 < p
    edge = [0, 1, bn254.P - 1, 2]
    vals[0] = np.asarray([bn254.int_to_limbs(v) for v in edge], dtype=np.int64)
    return torch.as_tensor(vals)


def check_bn254_kernel(dev, rng, lanes_list):
    err = 0
    for lanes in lanes_list:
        st = random_bn_states(lanes, rng).to(dev)
        got = kb.permute(st)
        want = kb.permute_plain(st)
        torch.cuda.synchronize()
        err = max(err, int((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"poseidon_bn254 kernel differs at {lanes} lanes")
    st = random_bn_states(lanes_list[-1], rng).to(dev)
    ms = cuda_ms(lambda: kb.permute(st), 20)
    plain_ms = cuda_ms(lambda: kb.permute_plain(st), 2)
    return err, ms, plain_ms


def check_transcript_kernel(dev, rng, spec):
    schedule = chal.build_schedule(spec)
    obs_np = rng.integers(0, gl.P, size=(STEP_BATCH, schedule.n_obs),
                          dtype=np.uint64)
    obs_np[0, :3] = [0, 1, gl.P - 1]
    obs = gl.split_u64(obs_np, dev)
    pi = gl.split_u64(rng.integers(0, gl.P, size=(STEP_BATCH, 4),
                                   dtype=np.uint64), dev)
    got = kt.run_transcript_kernel(schedule, obs, pi)
    want = kt.run_transcript_plain(schedule, obs, pi)
    torch.cuda.synchronize()
    err = max(int((got[i] - want[i]).abs().max()) for i in range(2))
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("transcript kernel differs from the plain scan")
    ms = cuda_ms(lambda: kt.run_transcript_kernel(schedule, obs, pi), 20)
    plain_ms = cuda_ms(lambda: kt.run_transcript_plain(schedule, obs, pi), 1)
    return err, ms, plain_ms, schedule.n_perms


def decode_block_batch():
    spec, raws, vraw = decode_block_lanes(TESTDATA / "decode_block")
    batch, mask, errors = serde.ingest_batch(spec, [(r, vraw) for r in raws])
    if errors:
        raise AssertionError(f"decode_block lanes quarantined: {errors}")
    return spec, batch, mask


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs an NVIDIA GPU")

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 1. build
    _, build_s = build.build(force=True)
    build.library()
    print(f"kernel build: {build_s:.2f} s (nvcc, sm_90a) [{card}]")

    # -- 2. kernels vs plain versions at the main path's shapes
    rng = np.random.default_rng(2024)
    spec_step, raw_step, vraw_step = load_fixture(TESTDATA / "step")
    Q = spec_step.num_query_rounds
    lanes = [STEP_BATCH * Q, STEP_BATCH * Q * 4]  # leaf scans, Merkle paths
    bn_err, bn_ms, bn_plain_ms = check_bn254_kernel(dev, rng, lanes)
    print(f"poseidon_bn254: bit-exact at {lanes} lanes; {lanes[-1]} lanes: "
          f"kernel {bn_ms:.4f} ms, plain {bn_plain_ms:.2f} ms [{card}]")
    tr_err, tr_ms, tr_plain_ms, n_perms = check_transcript_kernel(
        dev, rng, spec_step)
    print(f"transcript: bit-exact, step schedule ({n_perms} permutations) at "
          f"B={STEP_BATCH}: kernel {tr_ms:.4f} ms, plain {tr_plain_ms:.2f} ms "
          f"[{card}]")

    # -- 3. the main path
    good = serde.ingest_proof(spec_step, raw_step, vraw_step)
    bad = serde.ingest_proof(spec_step, corrupt_wires_opening(raw_step),
                             vraw_step)
    lanes_step = [good] * STEP_BATCH
    lanes_step[CORRUPT_LANE] = bad
    batch_step = serde.stack_proofs(lanes_step)
    spec_db, batch_db, mask_db = decode_block_batch()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kb.permute.launches = 0
    kt.run_transcript_kernel.launches = 0
    t0 = time.perf_counter()
    got_step = verifier.verify_batch(spec_step, batch_step, device=dev)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    got_db = verifier.verify_batch(spec_db, batch_db, valid_mask=mask_db,
                                   device=dev, diagnostics=True)
    launches = {"poseidon_bn254": kb.permute.launches,
                "poseidon_gl_transcript": kt.run_transcript_kernel.launches}
    peak = torch.cuda.max_memory_allocated(dev)

    expected = np.ones(STEP_BATCH, bool)
    expected[CORRUPT_LANE] = False
    if not np.array_equal(got_step, expected):
        bad_lanes = np.nonzero(got_step != expected)[0].tolist()
        raise AssertionError(f"step batch: wrong verdict in lanes {bad_lanes}")
    if got_db["verdict"].tolist() != [True, False, False, False]:
        raise AssertionError(f"decode_block verdicts {got_db}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} kernel not launched on the main path")

    # the first call pays one-time costs (constant tables, allocator warm-up)
    t0 = time.perf_counter()
    again = verifier.verify_batch(spec_step, batch_step, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if not np.array_equal(again, expected):
        raise AssertionError("step batch: second call gave another verdict")
    print(f"step B={STEP_BATCH}: lane {CORRUPT_LANE} rejected, "
          f"{STEP_BATCH - 1} accepted; wall per verified batch {step_s:.3f} s "
          f"first call, {warm_s:.3f} s second call "
          f"({STEP_BATCH / warm_s:.2f} proofs/s) [{card}]")
    print(f"decode_block [valid, bad opening, bad leaf, bad pow]: "
          f"{got_db['verdict'].tolist()}, plonk_ok "
          f"{got_db['plonk_ok'].tolist()}, fri_ok {got_db['fri_ok'].tolist()}")
    print(f"launches on the main path: {launches}")
    print(f"peak device memory: {peak / 2**20:.1f} MiB [{card}]")

    kernels = [
        {"name": "poseidon_bn254", "route": "cuda",
         "source": "plonky2_tpu_torch/csrc/poseidon_bn254.cu",
         "replaces": "plonky2_tpu/kernels/poseidon_bn254_mxu.py:253",
         "launches": launches["poseidon_bn254"], "max_abs_err": bn_err,
         "ms": bn_ms, "plain_ms": bn_plain_ms},
        {"name": "poseidon_gl_transcript", "route": "cuda",
         "source": "plonky2_tpu_torch/csrc/poseidon_gl_transcript.cu",
         "replaces": "plonky2_tpu/kernels/poseidon_gl_pallas.py:230",
         "launches": launches["poseidon_gl_transcript"], "max_abs_err": tr_err,
         "ms": tr_ms, "plain_ms": tr_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
