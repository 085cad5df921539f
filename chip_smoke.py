"""Smoke run of the PyTorch + CUDA verifier (plonky2_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. requires a CUDA device and prints its name and power limit;
2. builds the hand-written kernels from plonky2_tpu_torch/csrc (one nvcc per
   source, all started together);
3. checks each kernel bit-exact against its plain torch version on the card,
   at the main path's shapes, and times it beside its plain version; the two
   Poseidon-BN254 kernels (A, the default, and the CIOS kernel) are timed in
   turns (A, CIOS, CIOS, A);
4. the main path under PLONKY2_TPU_PB_IMPL=mxu: verifies 256 copies of
   testdata/step with one corrupted lane (only that lane may be rejected)
   and the decode_block batch [valid, bad opening, bad leaf, bad pow] (must
   give [True, False, False, False]); kernel A and the transcript kernel
   must have been launched, the CIOS kernel not; then the step batch again
   for the wall time per batch;
5. the same path under PLONKY2_TPU_PB_IMPL=cios: the same verdicts, the CIOS
   kernel and the transcript kernel launched, kernel A not;
6. stage times of the step batch (tools/profile_verify) under both settings;
7. one step batch under torch.profiler under each setting: kernel launches
   seen on the device, the device's busy share of the wall, and each
   hand-written kernel's device time per batch;
8. the soundness matrix on step (tools/soundness_matrix) under both
   settings: lane 0 True, every other lane False;
9. the command line: ``verify`` on decode_block and ``bench`` on step B=256.

Every phase must pass or the script exits non-zero.  Each kernel launch
counter is set to 0 just before the path it belongs to and read just after.
The last line of stdout is a JSON object with the device; the line before it
lists the kernels with their launches, errors, times and bounds.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from plonky2_tpu_torch import cli, verifier
from plonky2_tpu_torch.fields import bn254
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.kernels import build
from plonky2_tpu_torch.kernels import poseidon_bn254 as kb
from plonky2_tpu_torch.kernels import poseidon_bn254_cios as kc
from plonky2_tpu_torch.kernels import poseidon_gl_transcript as kt
from plonky2_tpu_torch.proof import serde
from plonky2_tpu_torch.proof.fixtures import (corrupt_wires_opening,
                                              decode_block_lanes, load_fixture)
from plonky2_tpu_torch.tools import profile_verify, soundness_matrix
from plonky2_tpu_torch.transcript import challenger as chal

TESTDATA = Path(__file__).resolve().parent / "testdata"
STEP_BATCH = 256
CORRUPT_LANE = 1
DECODE_EXPECTED = [True, False, False, False]

# Bounds: the larger of bytes over the memory rate and 32-bit integer
# multiply-adds (IMAD) over the card's IMAD rate, 132 SMs x 64 a clock at the
# SM clock that nvidia-smi reports as clocks.max.sm.
HBM_BYTES_PER_S = 3.35e12
SMS, IMAD_PER_SM_CLOCK = 132, 64
# A Poseidon-BN254 permutation: 784 256-bit products and 520 Montgomery
# reductions (the fused form's count), each 8 x 8 32-bit words, lo and hi.
BN254_PERM_IMADS = (784 + 520) * 2 * 8 * 8
# A Poseidon-GL permutation: 1099 Goldilocks products (8 full rounds of 12
# x^7 S-boxes at 4 products, 22 partial S-boxes, the 11 x 11 initial matrix,
# 22 sparse partial-round layers of 23) at 2 x 2 x 2 IMADs, and 8 x 144
# products by the MDS matrix's small entries at 2 x 2.
GL_PERM_IMADS = (4 * (8 * 12 + 22) + 11 * 11 + 22 * 23) * 8 + 8 * 144 * 4
NO_LIBRARY = None  # no PyTorch call computes a Poseidon permutation


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def imad_per_s():
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return SMS * IMAD_PER_SM_CLOCK * mhz * 1e6


def bound(imads, nbytes, rate):
    """(ms, what bounds it) for the larger of the two times."""
    ops_ms, bytes_ms = imads / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


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


@contextlib.contextmanager
def pb_impl(name):
    """Run the block with PLONKY2_TPU_PB_IMPL set to ``name``."""
    old = os.environ.get("PLONKY2_TPU_PB_IMPL")
    os.environ["PLONKY2_TPU_PB_IMPL"] = name
    try:
        yield
    finally:
        if old is None:
            del os.environ["PLONKY2_TPU_PB_IMPL"]
        else:
            os.environ["PLONKY2_TPU_PB_IMPL"] = old


def random_bn_states(n, rng):
    """(n, 4, 16) canonical Montgomery limbs; lane 0 holds 0, 1, p-1, 2."""
    vals = rng.integers(0, 1 << 16, size=(n, 4, 16), dtype=np.int64)
    vals[..., 15] &= 0x1FFF  # < 2^253 < p
    edge = [0, 1, bn254.P - 1, 2]
    vals[0] = np.asarray([bn254.int_to_limbs(v) for v in edge], dtype=np.int64)
    return torch.as_tensor(vals)


def check_bn254_kernels(dev, rng, lanes_list):
    """Both Poseidon-BN254 kernels bit-exact against the plain version at
    each lane count; at the last one, the kernels' times in turns (A, CIOS,
    CIOS, A) and each plain version's time."""
    err = {"a": 0, "cios": 0}
    for lanes in lanes_list:
        st = random_bn_states(lanes, rng).to(dev)
        want = kb.permute_plain(st)
        for key, kernel in (("a", kb), ("cios", kc)):
            got = kernel.permute(st)
            torch.cuda.synchronize()
            err[key] = max(err[key], int((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"poseidon_bn254 kernel {key} differs at "
                                     f"{lanes} lanes")
    st = random_bn_states(lanes_list[-1], rng).to(dev)
    turns = [("a", kb), ("cios", kc), ("cios", kc), ("a", kb)]
    ms = {"a": [], "cios": []}
    for key, kernel in turns:
        ms[key].append(cuda_ms(lambda: kernel.permute(st), 20))
    plain = {"a": cuda_ms(lambda: kb.permute_plain(st), 2),
             "cios": cuda_ms(lambda: kc.permute_plain(st), 2)}
    return err, ms, plain


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
    # bytes at the wrapper: obs and pi in, the states out, each a GL pair
    nbytes = 2 * 8 * STEP_BATCH * (schedule.n_obs + 4 + schedule.n_perms * 12)
    return err, ms, plain_ms, schedule.n_perms, nbytes


def decode_block_batch():
    spec, raws, vraw = decode_block_lanes(TESTDATA / "decode_block")
    batch, mask, errors = serde.ingest_batch(spec, [(r, vraw) for r in raws])
    if errors:
        raise AssertionError(f"decode_block lanes quarantined: {errors}")
    return spec, batch, mask


def reset_counters():
    kb.permute.launches = 0
    kc.permute.launches = 0
    kt.run_transcript_kernel.launches = 0


def read_counters():
    return {"poseidon_bn254": kb.permute.launches,
            "poseidon_bn254_cios": kc.permute.launches,
            "poseidon_gl_transcript": kt.run_transcript_kernel.launches}


def main_path(impl, dev, spec_step, batch_step, expected, spec_db, batch_db,
              mask_db):
    """Verify the step and decode_block batches under ``impl``; returns the
    verdicts, the launch counts of this path alone and the first-call wall."""
    with pb_impl(impl):
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        got_step = verifier.verify_batch(spec_step, batch_step, device=dev)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches_step = read_counters()
        got_db = verifier.verify_batch(spec_db, batch_db, valid_mask=mask_db,
                                       device=dev, diagnostics=True)
        launches = read_counters()
    if not np.array_equal(got_step, expected):
        bad_lanes = np.nonzero(got_step != expected)[0].tolist()
        raise AssertionError(f"{impl}: step batch wrong in lanes {bad_lanes}")
    if got_db["verdict"].tolist() != DECODE_EXPECTED:
        raise AssertionError(f"{impl}: decode_block verdicts {got_db}")
    used = "poseidon_bn254_cios" if impl == "cios" else "poseidon_bn254"
    unused = "poseidon_bn254" if impl == "cios" else "poseidon_bn254_cios"
    for name in (used, "poseidon_gl_transcript"):
        if launches[name] <= 0:
            raise AssertionError(f"{impl}: {name} kernel not launched")
    if launches[unused] != 0:
        raise AssertionError(f"{impl}: {unused} kernel launched "
                             f"{launches[unused]} times")
    return got_db, launches, launches_step, step_s


def profile_batch(impl, spec, batch, dev):
    """One verify_batch under torch.profiler: (wall s, device kernel and
    copy events seen, device busy s, {kernel: (launches, device s)})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {"poseidon_bn254": "poseidon_bn254_kernel",
             "poseidon_bn254_cios": "poseidon_bn254_cios_kernel",
             "poseidon_gl_transcript": "transcript_kernel"}
    with pb_impl(impl), profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        verifier.verify_batch(spec, batch, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in on_device) / 1e6
    per_kernel = {}
    for key, needle in names.items():
        hits = [e for e in on_device if needle in e.name]
        per_kernel[key] = (len(hits),
                           sum(e.time_range.elapsed_us() for e in hits) / 1e6)
    return wall, len(on_device), busy, per_kernel


def run_cli(argv, card):
    """cli.main(argv) in this process; its report line, tagged with the card."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)}: exit {rc}\n{buf.getvalue()}")
    report = buf.getvalue().strip().splitlines()[-1]
    print(f"cli {argv[0]}: {report} [{card}]")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs an NVIDIA GPU")

    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, Python "
          f"{sys.version.split()[0]}, nvcc {build.nvcc_version()}")
    rate = imad_per_s()
    print(f"IMAD rate for the bounds: {rate:.4e}/s "
          f"(132 SMs x 64 x clocks.max.sm) [{card}]")

    # -- 1. build
    _, build_s = build.build(force=True)
    build.library()
    print(f"kernel build: {build_s:.2f} s (nvcc, sm_90a, one process per "
          f"source) [{card}]")

    # -- 2. kernels vs plain versions at the main path's shapes
    rng = np.random.default_rng(2024)
    spec_step, raw_step, vraw_step = load_fixture(TESTDATA / "step")
    Q = spec_step.num_query_rounds
    lanes = [STEP_BATCH * Q, STEP_BATCH * Q * 4]  # leaf scans, Merkle paths
    bn_err, bn_ms, bn_plain = check_bn254_kernels(dev, rng, lanes)
    print(f"poseidon_bn254 kernels A and CIOS: bit-exact at {lanes} lanes; "
          f"{lanes[-1]} lanes in turns A, CIOS, CIOS, A: "
          f"{bn_ms['a'][0]:.4f}, {bn_ms['cios'][0]:.4f}, "
          f"{bn_ms['cios'][1]:.4f}, {bn_ms['a'][1]:.4f} ms; plain "
          f"{bn_plain['a']:.2f} and {bn_plain['cios']:.2f} ms [{card}]")
    tr_err, tr_ms, tr_plain_ms, n_perms, tr_bytes = check_transcript_kernel(
        dev, rng, spec_step)
    print(f"transcript: bit-exact, step schedule ({n_perms} permutations) at "
          f"B={STEP_BATCH}: kernel {tr_ms:.4f} ms, plain {tr_plain_ms:.2f} ms "
          f"[{card}]")

    # -- 3. the main path (mxu, the default), then the cios path
    good = serde.ingest_proof(spec_step, raw_step, vraw_step)
    bad = serde.ingest_proof(spec_step, corrupt_wires_opening(raw_step),
                             vraw_step)
    lanes_step = [good] * STEP_BATCH
    lanes_step[CORRUPT_LANE] = bad
    batch_step = serde.stack_proofs(lanes_step)
    spec_db, batch_db, mask_db = decode_block_batch()
    expected = np.ones(STEP_BATCH, bool)
    expected[CORRUPT_LANE] = False
    args = (dev, spec_step, batch_step, expected, spec_db, batch_db, mask_db)

    torch.cuda.reset_peak_memory_stats(dev)
    got_db, launches, launches_step, step_s = main_path("mxu", *args)
    peak = torch.cuda.max_memory_allocated(dev)
    # the first call pays one-time costs (constant tables, allocator warm-up)
    t0 = time.perf_counter()
    again = verifier.verify_batch(spec_step, batch_step, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if not np.array_equal(again, expected):
        raise AssertionError("step batch: second call gave another verdict")
    print(f"mxu: step B={STEP_BATCH}: lane {CORRUPT_LANE} rejected, "
          f"{STEP_BATCH - 1} accepted; wall per verified batch {step_s:.3f} s "
          f"first call, {warm_s:.3f} s second call "
          f"({STEP_BATCH / warm_s:.2f} proofs/s) [{card}]")
    print(f"mxu: decode_block [valid, bad opening, bad leaf, bad pow]: "
          f"{got_db['verdict'].tolist()}, plonk_ok "
          f"{got_db['plonk_ok'].tolist()}, fri_ok {got_db['fri_ok'].tolist()}")
    print(f"mxu: launches on the main path: {launches}; of them the step "
          f"batch: {launches_step}")
    print(f"mxu: peak device memory: {peak / 2**20:.1f} MiB [{card}]")

    got_db_c, launches_c, launches_c_step, step_c_s = main_path("cios", *args)
    for key in ("verdict", "plonk_ok", "fri_ok"):
        if not np.array_equal(got_db_c[key], got_db[key]):
            raise AssertionError(f"cios: decode_block {key} differs from mxu")
    print(f"cios: step B={STEP_BATCH}: lane {CORRUPT_LANE} rejected, "
          f"{STEP_BATCH - 1} accepted, wall {step_c_s:.3f} s; decode_block "
          f"{got_db_c['verdict'].tolist()}, as under mxu [{card}]")
    print(f"cios: launches on the path: {launches_c}; of them the step "
          f"batch: {launches_c_step}")

    # -- 4. stage times (tools/profile_verify), in turns
    for impl in ("mxu", "cios", "cios", "mxu"):
        with pb_impl(impl):
            st = profile_verify.profile_stages(spec_step, batch_step, dev)
        if not np.array_equal(st.pop("verdicts"), expected):
            raise AssertionError(f"{impl}: stage probe gave other verdicts")
        print(f"stages {impl} step B={STEP_BATCH} (s): "
              f"{json.dumps(st)} [{card}]")

    # -- 5. one profiled step batch under each setting
    for impl in ("mxu", "cios"):
        wall, n_dev, busy, per_kernel = profile_batch(impl, spec_step,
                                                      batch_step, dev)
        used = "poseidon_bn254_cios" if impl == "cios" else "poseidon_bn254"
        if busy <= 0 or per_kernel[used][0] == 0:
            raise AssertionError(f"{impl}: the profile shows no {used} launch")
        kern = ", ".join(f"{k} {n} launches {t:.6f} s"
                         for k, (n, t) in per_kernel.items() if n)
        print(f"profile {impl} step B={STEP_BATCH}: wall {wall:.4f} s under "
              f"the profiler, {n_dev} device events, device busy "
              f"{busy:.4f} s ({busy / wall:.4f} of the wall); {kern} [{card}]")

    # -- 6. soundness matrix on step
    for impl in ("mxu", "cios"):
        with pb_impl(impl):
            sm = soundness_matrix.run("step", dev)
        if not sm["all_correct"]:
            raise AssertionError(f"{impl}: soundness matrix {sm['rows']}")
        print(f"soundness matrix {impl}: step, {sm['lanes']} lanes, "
              f"all_correct {sm['all_correct']}")

    # -- 7. the command line
    run_cli(["verify", "--circuit", str(TESTDATA / "decode_block"),
             "--batch", "4"], card)
    run_cli(["bench", "--circuit", str(TESTDATA / "step"),
             "--batch", str(STEP_BATCH), "--iters", "3"], card)

    bn_bound, bn_by = bound(lanes[-1] * BN254_PERM_IMADS, lanes[-1] * 1024,
                            rate)
    tr_bound, tr_by = bound(n_perms * STEP_BATCH * GL_PERM_IMADS, tr_bytes,
                            rate)
    kernels = [
        {"name": "poseidon_bn254", "route": "cuda",
         "source": "plonky2_tpu_torch/csrc/poseidon_bn254.cu",
         "replaces": "plonky2_tpu/kernels/poseidon_bn254_mxu.py:253",
         "launches": launches["poseidon_bn254"], "max_abs_err": bn_err["a"],
         "ms": float(np.mean(bn_ms["a"])), "plain_ms": bn_plain["a"],
         "bound_ms": bn_bound, "bound_by": bn_by, "library_ms": NO_LIBRARY},
        {"name": "poseidon_bn254_cios", "route": "cuda",
         "source": "plonky2_tpu_torch/csrc/poseidon_bn254_cios.cu",
         "replaces": "plonky2_tpu/kernels/poseidon_bn254_pallas.py:263",
         "launches": launches_c["poseidon_bn254_cios"],
         "max_abs_err": bn_err["cios"],
         "ms": float(np.mean(bn_ms["cios"])), "plain_ms": bn_plain["cios"],
         "bound_ms": bn_bound, "bound_by": bn_by, "library_ms": NO_LIBRARY},
        {"name": "poseidon_gl_transcript", "route": "cuda",
         "source": "plonky2_tpu_torch/csrc/poseidon_gl_transcript.cu",
         "replaces": "plonky2_tpu/kernels/poseidon_gl_pallas.py:230",
         "launches": launches["poseidon_gl_transcript"], "max_abs_err": tr_err,
         "ms": tr_ms, "plain_ms": tr_plain_ms,
         "bound_ms": tr_bound, "bound_by": tr_by, "library_ms": NO_LIBRARY},
    ]
    print(f"kernel bounds at the timed shapes: BN254 {lanes[-1]} lanes "
          f"{bn_bound:.4f} ms, transcript {n_perms} x {STEP_BATCH} "
          f"permutations {tr_bound:.4f} ms [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
