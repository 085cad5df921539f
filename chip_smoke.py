"""Smoke run of the PyTorch + CUDA verifier (plonky2_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. requires a CUDA device and prints its name and power limit;
2. builds the hand-written kernels from plonky2_tpu_torch/csrc (one nvcc per
   source, all started together);
3. checks each kernel bit-exact against its plain torch version on the card,
   at the main path's shapes and at the shapes its tiling makes risky
   (Poseidon-BN254: lane counts off kernel A's 64-lane tile and the CIOS
   kernel's tiles, either side of the CIOS kernel's switch between its two
   kernels, and strided input; the transcript: odd batches, on both
   fixtures' schedules), and times it beside its plain version; the two
   Poseidon-BN254 kernels (A, the default, and the CIOS kernel) are timed in
   turns (A, CIOS, CIOS, A) at both lane counts the main path launches and
   at half of each, the lane counts of a step batch split in two; one
   dependent Goldilocks product's latency is timed for the transcript's
   latency bound; ``ptxas -v``'s report of every kernel is printed; the
   quadratic-extension chain kernels (Horner, powers, inverse) and the
   public-input sponge (the transcript kernel over HashNoPad's blocks) are
   checked bit-exact at every shape the main path gives them (both
   fixtures, B=256) and at lane counts off their blocks, with broadcast and
   strided inputs, the edge values and x = 0 and 1, Horner and powers also
   at n around their group widths (31 to 65), n = 1000 and every group
   width, the inverse at element counts around a warp's 32 K elements with
   0 at warp edges and in a whole warp, at every K elements a thread, and
   on transposed, broadcast and sliced views against contiguous copies;
   each is timed at its largest main-path shape through a CUDA graph of 20
   launches beside its plain version's replay and eager times, Horner and
   powers at each of their calls in a step verification at the group width
   the wrapper picks and at every other, and the inverse at each of its
   calls at the K the wrapper picks and at every other; the PLONK stage's
   product
   kernels (Goldilocks a b and a c, QE a b and a b + c) are checked
   bit-exact at the main path's shapes (B=256, the largest (256, 28, 16, 8))
   and at lane counts off their 128-thread blocks, on every broadcast
   pattern of the call sites, strided views, an empty lead shape and the
   constants 0, 1, 7 and DTH_ROOT, the bit-selected product by a constant
   (fields/goldilocks.mul_const_bits) at both fixtures' subgroup_x and
   cosetStart calls, odd lane counts, 64-bit indices, bits up to 63, odd
   and full tables and strided and broadcast operands, and the
   coset-interpolation scan on both fixtures' gates at B=256 and odd lane
   counts, with the edge values in every coordinate and points equal to a
   domain point (a zero t), against its plain version on CPU copies; each
   is timed at its
   largest main-path shape in a CUDA graph of 20 launches beside its plain
   version (every product plain), and the bit-selected product at its 3
   calls beside the loop it replaced; the Poseidon-BN254 rows carry a
   latency bound beside their throughput bound, and the scan its two forms'
   bounds and chains; FRI's chain kernels (csrc/fri_merkle.cu, every
   leaf sponge and Merkle climb of a verification in one launch) on the
   main path's real inputs, step B=256 (43,008 chains) and decode_block
   B=4, in turns A, CIOS, CIOS, A: each bit-exact against
   fri/merkle.merkle_roots_plain, as is the per-level form (one
   single-permutation launch an absorb step and tree level, 63 on step),
   each timed in a CUDA graph beside the per-level form, with its bound
   and its launch's layout (slot types and their fill, blocks, registers,
   spills, resident blocks an SM, waves);
4. the main path under PLONKY2_TPU_PB_IMPL=mxu, through the compiled
   verifier (one CUDA graph per key, captured at the key's first call; the
   cache emptied first): verifies 256 copies of testdata/step with one
   corrupted lane (only that lane may be rejected) and the decode_block
   batch [valid, bad opening, bad leaf, bad pow] (must give [True, False,
   False, False]); the Python launch counters, which see a key's eager
   warm-up and its capture but no replay, must read FRI's chain kernel
   merkle_chains_a 4 times (2 x 2: one launch a verification, where the
   per-level form launched kernel A 63 and 60 times), the
   single-permutation kernels never, the transcript kernel 4 times, the public-input sponge 2
   times (step has 36 public inputs, decode_block none), QE Horner 32, QE
   powers 8 and QE inverse 28 times (8, 2 and 7 a verification), the
   Goldilocks product 64, the product by a constant 68, the QE product
   614 and the interpolation scan 4 times (16, 17, 154 and 153, 1 a
   verification of step and decode_block), merkle_chains_cios never;
5. the same path under PLONKY2_TPU_PB_IMPL=cios: the same verdicts,
   merkle_chains_cios (4) and the transcript kernel launched,
   merkle_chains_a not;
6. the compiled verifier under each setting: the replay's verdict, plonk_ok
   and fri_ok equal the eager verify_device's, bit for bit, on both batches;
   the same graphs re-fed (the corrupted step lane moved to 200, the
   decode_block lanes in another order) give their own verdicts; a step
   batch with one query round raises ValueError and the next replay is
   still right; two step batches of one key loaded and replayed back to
   back, the first one's copy to the card held back on the stream, give
   their own verdicts; the graph's inputs are the narrow layout (every
   static input int32, the batch packed into a pinned buffer and copied in
   one transfer), whose bytes a call are printed beside the int64
   layout's; one replay under torch.profiler launches the chain kernel
   of the setting once (the per-level form: kernel A or the CIOS kernel 63
   times), the transcript kernel twice (the sponge and the
   transcript), QE Horner 8, QE powers 2 and QE inverse 7 times, the
   products 16, 17 and 154 times and the interpolation scan once, and gives
   the device's events (against 9,180 with a Poseidon-BN254 launch an
   absorb step and tree level, 9,114 with int64 inputs, 9,146 with the
   scan's operands gathered and concatenated by plain kernels, 61,926 with
   the products plain) and busy
   share; the eager wall against the median of 5 replays, the first call
   with its warm-up and capture, and the peak device memory with the graphs
   held;
7. stage times of the step batch (tools/profile_verify, eager) under both
   settings; then, in turns mxu, cios, cios, mxu, the probe on the
   compiled path: the transcript, plonk and fri phases each captured in its
   own CUDA graph (tools/profile_verify --mode phases: capture, first,
   best and median replay and CUDA-event times, plonk_only and fri_only,
   the whole graph beside them, peak memory), whose plonk and fri outputs
   must equal the compiled verifier's plonk_ok and fri_ok on every lane and
   whose replays must launch each phase's kernels (transcript: the sponge
   and the transcript; plonk: those and 5 QE Horner, 1 inverse, 4, 12 and
   128 products and the scan; fri: those and the chain kernel, 3 Horner,
   2 powers, 6 inverse, 12, 5 and 26 products), and the host stages of a
   replayed verify_batch (--mode replayed: observed, convert, copy_in,
   replay, outputs, read_back, mask) beside the call without the timer,
   whose verdicts must be the expected ones; one eager step batch under
   torch.profiler under each setting: kernel launches seen on the device,
   the device's busy share of the wall, and each hand-written kernel's
   device time per batch;
8. the soundness matrix on step (tools/soundness_matrix) under both
   settings: lane 0 True, every other lane False, with its launch counts;
9. the command line: ``verify`` on decode_block and ``bench`` on step B=256
   (through the graph; its first call, capture included, apart), each with
   its launch counts;
10. the parallel paths (parallel/mesh.py, parallel/distributed.py), each
   through the compiled verifier, its cache emptied first, on the step
   batch (lane 1 corrupted, the same verdicts as verify_batch) with its own
   launch counts (a warm-up and a capture per key, every kernel of the path
   counted), and the wall of a second call
   (replays): the 1-D mesh over every GPU; the (2, 1) mesh on [cuda:0,
   cuda:0], whose two proof shards share one graph, with the corrupted lane
   in the second shard, once more with the first shard's copy to the card
   held back on the stream; the (1, 2) proof x query mesh over [cuda:0,
   cuda:0], whose chain kernel runs B*Q/2 = 3584 lanes of each chain kind,
   and on it the decode_block batch [valid, bad opening, a
   leaf corrupted in the last query round, a proof that fails ingest] (must
   give [True, False, False, False]); verify_batch_distributed in a group
   of one (NCCL); two ranks as subprocesses, B=128 each, lane 129 corrupted
   (NCCL with a GPU each, else gloo, both on cuda:0); one short run of
   tools/micro_pb (the single-permutation kernels' own path since FRI's
   chain kernels; the kernels line gives their launches there) and of
   tools/scaling_bench (whose sizes above the GPU count are "not
   measured").

Every phase must pass or the script exits non-zero.  Each kernel launch
counter is set to 0 just before the path it belongs to and read just after;
the counters count the wrappers' calls, so a graph's replays, which launch
the kernels inside the graph, are counted under torch.profiler instead.
The last line of stdout is a JSON object with the device; the line before it
lists the kernels with their launches, errors, times and bounds.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from plonky2_tpu_torch import cli, verifier
from plonky2_tpu_torch.fields import bn254
from plonky2_tpu_torch.fields import goldilocks as gl
from plonky2_tpu_torch.fields import goldilocks_ext as qe
from plonky2_tpu_torch.fri import merkle
from plonky2_tpu_torch.fri import verify as fv
from plonky2_tpu_torch.gates import gates as G
from plonky2_tpu_torch.hash import poseidon_bn254 as pb
from plonky2_tpu_torch.hash import poseidon_gl as pgl
from plonky2_tpu_torch.kernels import build
from plonky2_tpu_torch.kernels import fri_merkle as kf
from plonky2_tpu_torch.kernels import goldilocks_ext as kq
from plonky2_tpu_torch.kernels import goldilocks_mul as km
from plonky2_tpu_torch.kernels import launches as kernel_launches
from plonky2_tpu_torch.kernels import poseidon_bn254 as kb
from plonky2_tpu_torch.kernels import poseidon_bn254_cios as kc
from plonky2_tpu_torch.kernels import poseidon_gl_transcript as kt
from plonky2_tpu_torch.parallel import distributed
from plonky2_tpu_torch.parallel import mesh as pmesh
from plonky2_tpu_torch.proof import convert, serde
from plonky2_tpu_torch.proof.fixtures import (corrupt_wires_opening,
                                              decode_block_lanes, load_fixture,
                                              query_shard_lanes)
from plonky2_tpu_torch.tools import (dist_worker, micro_pb, profile_verify,
                                     scaling_bench, soundness_matrix)
from plonky2_tpu_torch.transcript import challenger as chal
from plonky2_tpu_torch.utils.profiling import device_kernels

TESTDATA = Path(__file__).resolve().parent / "testdata"
STEP_BATCH = 256
CORRUPT_LANE = 1
DECODE_EXPECTED = [True, False, False, False]

# Bounds: the larger of bytes over the memory rate and the operations over
# their unit's rate: 32-bit integer multiply-adds (IMAD) at 132 SMs x 64 a
# clock at the SM clock that nvidia-smi reports as clocks.max.sm, int8
# tensor-core products at the published 1,979 TOP/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
SMS, IMAD_PER_SM_CLOCK = 132, 64
# A Poseidon-BN254 permutation, in the least costly of its two known forms.
# A general 256-bit product and a Montgomery reduction are 8 x 8 32-bit word
# products, lo and hi (128 IMADs); a squaring is 36 word products (72 IMADs).
# Of the 88 S-boxes' 264 products, 176 are the squarings x^2 and x^4. The
# CIOS form adds 520 linear-layer products by constants and reduces 520
# times; the tensor-core form keeps the S-boxes and 520 reductions on the
# IMADs and puts the 64 rounds' linear layers on the int8 tensor cores,
# 128 x 128 byte products each (2 operations a product).
BN254_SBOX_IMADS = 88 * 128 + 176 * 72
BN254_CIOS_IMADS = BN254_SBOX_IMADS + (520 + 520) * 128
BN254_TC_IMADS = BN254_SBOX_IMADS + 520 * 128
BN254_TC_INT8_OPS = 64 * 128 * 128 * 2
# A Poseidon-GL permutation: 118 x^7 S-boxes (8 full rounds of 12, 22
# partial) of 2 products and 2 squarings, the 11 x 11 initial matrix and
# 22 sparse partial-round layers of 23 products; a product of 2 x 2 32-bit
# words, lo and hi, is 8 IMADs, a squaring 6; and 8 x 144 products by the
# MDS matrix's small entries at 2 x 2.
GL_PERM_IMADS = ((8 * 12 + 22) * (2 * 8 + 2 * 6) + (11 * 11 + 22 * 23) * 8
                 + 8 * 144 * 4)
# Dependent Montgomery products on the critical path of one Poseidon-BN254
# permutation (hash/poseidon_bn254.py): a round's S-box x^5 is 3 deep (x^2,
# x^4, x^4 x), its linear layer 1 (products by constants, each reduced, then
# summed); a partial round's S-box is on one element.  Times L, the
# latency of one dependent Goldilocks product, a lower bound on that of a
# Montgomery product over 256 bits: the permutation's latency bound.
BN254_PERM_DEPTH = (pb.FULL_ROUNDS + pb.PARTIAL_ROUNDS) * (3 + 1)
# Dependent Goldilocks products on the shortest critical path of one
# permutation (counted in csrc/poseidon_gl_transcript.cu): a full round is
# 4 (x^7 in 3, then the MDS row); row 0 of the initial matrix is the
# identity; a partial round is 3 (x^7 w0 as x^4 (x^3 w0), with x w0 beside
# x^2 and x^3 w0 beside x^4; pc w0 is a constant, and the rest sum needs
# only depth 2 from the round's input).
GL_PERM_DEPTH = 8 * 4 + 22 * 3
NO_LIBRARY = None  # no PyTorch call computes a Poseidon permutation or a
#                   Goldilocks product
# The single-permutation Poseidon-BN254 kernels' own path since FRI's chain
# kernels took the main path's permutations: the BN254 chains of micro_pb.
SINGLE_PERMUTATION_PATH = "tools/micro_pb"
# Off kernel A's 64-lane tile, the CIOS group kernel's 32-lane and its lane
# kernel's 128-lane tile, and either side of the CIOS kernel's switch from
# the group to the lane kernel (2 warps an SM of one thread a lane: 8448
# lanes on the H100's 132 SMs).
BN_LANES_RISKY = [1, 31, 33, 63, 65, 1000, 8447, 8448, 28673]
TRANSCRIPT_BATCHES = [1, 3, 17, STEP_BATCH, STEP_BATCH + 1]
# The main path's launches: step B=256 and decode_block B=4, one FRI chain
# kernel launch a verification (every leaf sponge and Merkle climb), one
# transcript launch a batch, in each of the two runs of verify_device at a
# key's first call (the eager warm-up and the capture); a replay launches
# them inside the graph.  Before the chain kernels a verification launched
# the single-permutation Poseidon-BN254 kernel once an absorb step and tree
# level: 63 times on step (51 at B x Q lanes, 12 at 4 B x Q), 60 on
# decode_block; the main path launches it no more (tools/micro_pb does).
CAPTURE_RUNS = 2
CHAIN_KERNEL_LAUNCHES = 1
PER_LEVEL_BN254_LAUNCHES = {"step": 63, "decode_block": 60}
# FRI's chain kernel of each Poseidon-BN254 setting: (form, wrapper's
# counter name).
CHAIN_FORMS = {"mxu": ("a", "merkle_chains_a"),
               "cios": ("cios", "merkle_chains_cios")}
# Of one verification on either fixture: the call sites of
# fields/goldilocks_ext.horner (8), powers (2) and inv (7); and one
# public-input sponge launch where the circuit has public inputs (step: 36,
# decode_block: none, whose hash is zeros without a launch).
CHAIN_LAUNCHES = {"qe_horner": 8, "qe_powers": 2, "qe_inv": 7}
PI_HASH_LAUNCHES = {"step": 1, "decode_block": 0}
# Of one verification: the calls of fields/goldilocks.mul, mul_const (c
# not 0 or 1) and mul_const_bits (FRI's subgroup_x, one, and each
# reduction round's cosetStart, one a round) and of
# fields/goldilocks_ext.mul and mul_add (square, ea_mul, prod_axis, div,
# ... reach them), and the interpolation gate's scan; the same on a query
# shard (counted on the CPU through each wrapper's arithmetic, the dispatch
# forced).  Before the bit-selected product, subgroup_x's loop made lde_bits
# + 1 products by a constant and each round's cosetStart arity_bits and a
# Goldilocks product: 39 and 18 on step, 38 and 18 on decode_block.
PRODUCT_LAUNCHES = {
    "step": {"gl_mul": 16, "gl_mul_const": 17, "qe_mul": 154,
             "coset_interp_scan": 1},
    "decode_block": {"gl_mul": 16, "gl_mul_const": 17, "qe_mul": 153,
                     "coset_interp_scan": 1}}
REPLAYS = 5
# The kernels one replay of each phase graph of tools/profile_verify
# launches on step (the profiler counts the public-input sponge under the
# transcript kernel): the transcript phase the sponge and the transcript;
# plonk and fri each that, then its own (counted on the CPU through each
# wrapper's arithmetic, the dispatch forced).  plonk + fri - transcript is
# one verification's (profiled_launches).
PHASE_LAUNCHES = {
    "transcript": {"poseidon_gl_transcript": 2},
    "plonk": {"poseidon_gl_transcript": 2, "qe_horner": 5, "qe_inv": 1,
              "gl_mul": 4, "gl_mul_const": 12, "qe_mul": 128,
              "coset_interp_scan": 1},
    "fri": {"chains": CHAIN_KERNEL_LAUNCHES, "poseidon_gl_transcript": 2,
            "qe_horner": 3, "qe_powers": 2, "qe_inv": 6, "gl_mul": 12,
            "gl_mul_const": 5, "qe_mul": 26}}
# A step replay issued 367,045 device events while the chains and the
# public-input hash still ran as plain torch, and 61,926 with them on the
# card and the products plain, 9,268 with the products on the card before
# the bit-selected product, and 9,146 before the interpolation scan read
# its operands from the wires (PERF.md §5 and §6, NVIDIA H100 80GB HBM3,
# 700.00 W).
# A profiled call of the compiled verifier on prepared tensors gave 9,114
# events while the graph took the wide int64 layout (its inputs copied in
# as 66 int64 tensors), and 9,180 with the narrow layout while FRI's hash
# chains ran a Poseidon-BN254 launch an absorb step and tree level with
# plain ops between (PERF.md §5).
PER_LEVEL_BN254_REPLAY_EVENTS = 9180
PLAIN_CHAINS_REPLAY_EVENTS = 367045
PLAIN_PRODUCTS_REPLAY_EVENTS = 61926
LOOP_PRODUCTS_REPLAY_EVENTS = 9268
GATHERED_SCAN_REPLAY_EVENTS = 9146
WIDE_INPUTS_REPLAY_EVENTS = 9114
# Cycles the stream sleeps before the first of two back-to-back loads of one
# key (some 34 ms at 1980 MHz): its copy to the card waits behind them, so a
# second pack that did not wait for that copy would overwrite its bytes.
BACK_TO_BACK_SLEEP_CYCLES = 1 << 26
# The chain kernels' checked shapes: (terms, x) of every horner call at B=256
# on step and decode_block (the final polynomial is 32 and 16 long, the FRI
# batch 258 and 257), lane counts off the chains' blocks (whole warps, about
# lanes x G / 132 threads), n = 1, terms that broadcast against x, n at and
# around the group widths (31, 32, 33, 64, 65) and n = 1000; the powers'
# main-path shapes and the same.  Every x of two or more lanes holds 0 in
# its last lane and, from six lanes, 1 in lane 5 (qe_values).
HORNER_CASES = [((256, 63), ()), ((256, 4, 4), ()), ((256, 145), (256,)),
                ((256, 2, 8), (256, 1)), ((256, 258), (256,)),
                ((256, 257), (256,)), ((256, 2), (256,)),
                ((256, 1, 32), (256, 28)), ((256, 1, 16), (256, 28)),
                ((1, 5), (1,)), ((31, 7), (31,)), ((33, 7), (33,)),
                ((255, 9), (255,)), ((257, 9), (257,)), ((65, 1), (65,)),
                ((1, 9), (40,)), ((256, 31), (256,)), ((256, 32), (256,)),
                ((256, 33), (256,)), ((256, 64), (256,)),
                ((256, 65), (256,)), ((7, 1000), (7,)),
                ((7169, 32), (7169,)), ((1023, 4), (1023,)),
                ((257, 65), (257,))]
POWERS_CASES = [(256, 258), (256, 257), (256, 2), (1, 5), (31, 5), (33, 5),
                (255, 9), (257, 9), (256, 1), (256, 31), (256, 32),
                (256, 33), (256, 64), (256, 65), (7, 1000), (7169, 32),
                (257, 65)]
# Every group width is checked at these (lanes, n), Horner and powers.
GROUP_CASES = [(256, 258), (7168, 32), (33, 65)]
# The chains' calls in one step verification at B=256: (kernel, terms shape
# or lanes, x shape or n, calls): gates/gates.py:152 and :390,
# plonk_checks/vanishing.py:89 (twice) and :96, fri/verify.py:147, :148 and
# :249 (the final polynomial at 256 x 28 lanes); powers at fri/verify.py:193
# and :208.
CHAIN_CALLS = [("qe_horner", (256, 63), (), 1),
               ("qe_horner", (256, 4, 4), (), 1),
               ("qe_horner", (256, 145), (256,), 2),
               ("qe_horner", (256, 2, 8), (256, 1), 1),
               ("qe_horner", (256, 258), (256,), 1),
               ("qe_horner", (256, 2), (256,), 1),
               ("qe_horner", (256, 1, 32), (256, 28), 1),
               ("qe_powers", (256,), 258, 1),
               ("qe_powers", (256,), 2, 1)]
GROUPS = [1, 2, 4, 8, 16, 32]
# The inverse's checked shapes: its main-path shapes at B=256 and element
# counts around a warp's 32 K elements (K = 1, 2, 4, 8); each case holds 0
# at element 0, 31 and the last, and from 512 elements on in [256, 512),
# a whole warp at every K (inv_values); each is checked at every K.
INV_CASES = [(256,), (256, 28), (256, 28, 16), (1,), (31,), (32,), (33,),
             (255,), (257,), (7168,)]
# The inverse's calls in one step verification at B=256:
# plonk_checks/vanishing.py:49, fri/verify.py:193 and :207, and :285 and
# :292 in each of the 2 reduction rounds.
INV_CALLS = [((256,), 1), ((256, 28), 2), ((256, 28, 16), 4)]
PER_THREAD = [1, 2, 4, 8]
PI_HASH_N = [0, 1, 7, 8, 9, 36]
GL_EDGE = [0, 1, gl.P - 1, (1 << 32) - 1, 1 << 32, gl.P - (1 << 32)]
# IMADs of the chains' functions, with a Goldilocks product at 8 and a
# squaring at 6: a Horner or powers step is a QE product by a fixed x,
# 4 products once 7 x1 is made (one product a lane).  The inverse in its
# batch form (csrc/goldilocks_ext.cu): an element's norm (a0^2, a1 conj1,
# times W), its running product, the walk back (2) and the scaling (2);
# a warp's two 5-step scans, q[K - 1]^-1 (2) and one inversion of its
# total (64 squarings and 9 products).  Its one-inversion-an-element form
# was 14 products and 65 squarings an element, 75 products deep.
QE_STEP_IMADS = 4 * 8
QE_INV_ELEMENT_IMADS = 6 + 7 * 8
QE_INV_WARP_IMADS = (10 + 2 + 9) * 8 + 64 * 6
QE_INV_ELEMENT_FORM_IMADS = 14 * 8 + 65 * 6
QE_INV_DEPTH = 75  # dependent products of one inverse an element
# The products: a Goldilocks product is 8 IMADs and reads 32 B and writes
# 16 B an element (a product by a constant reads 16 B); a QE product is 5
# Goldilocks products (W b1 first) and reads 64 B and writes 32 B.  An
# extension-algebra product is 4 QE products and 2 products by W, 22
# Goldilocks products, 3 deep (W b1, the product by it, the Y^2 part by W).
# The interpolation scan in the JAX form: a step is val_j w_j (4) and three
# EA products, and each running value waits on one EA product a step.  In
# the kernel's prefix-suffix form each of a chunk's S = 2^k >= deg threads
# makes w_j v_j (4), k rounds of a prefix and a suffix product and two
# products into its term, and the chunk's first thread 3 EA products more;
# the chain is k rounds, the term's two products and pr0 sum: k + 3 EA
# products.
GL_MUL_IMADS = 8
QE_MUL_IMADS = 5 * 8
EA_MUL_PRODUCTS = 22
EA_MUL_DEPTH = 3
SCAN_STEP_IMADS = (4 + 3 * EA_MUL_PRODUCTS) * GL_MUL_IMADS
# The product kernels' checked shapes: the main path's at B=256 (the
# largest, (256, 28, 16, 8), is prod_axis over the FRI openings) and lane
# counts off the 128-thread blocks; the constants of mul_const.
PRODUCT_SHAPES = [(256,), (256, 28), (256, 80), (256, 4, 12), (256, 28, 16),
                  (256, 28, 16, 8), (1,), (31,), (33,), (255,), (257,)]
MUL_CONSTS = [0, 1, 7, gl.DTH_ROOT]
# The bit-selected product's lane counts off its 128-thread blocks.
BITS_LANES = [1, 31, 33, 255, 257]
SCAN_LANES = [STEP_BATCH, 1, 31, 33, 255, 257]
GRAPH_LAUNCHES = 20
# FRI's chains in a graph: a step batch's are 709,632 permutations a call
CHAIN_GRAPH_LAUNCHES = 5
# The refed step batch: the corrupted lane moved.
MOVED_LANE = 200
DECODE_ORDER = [3, 0, 2, 1]
# Two ranks of B=128 each: the corrupted lane lies in rank 1's half.
RANKS_CORRUPT_LANE = STEP_BATCH // 2 + CORRUPT_LANE


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def imad_per_s():
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return SMS * IMAD_PER_SM_CLOCK * mhz * 1e6


def bound(ops_ms, nbytes):
    """(ms, what bounds it) for the larger of the operations' time and the
    bytes' time."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def bn254_bound(lanes, rate):
    """(ms, what bounds it, form) of ``lanes`` Poseidon-BN254 permutations:
    the least time over the function's two known forms; each lane reads and
    writes 512 bytes."""
    cios_ms = lanes * BN254_CIOS_IMADS / rate * 1e3
    tc_ms = max(lanes * BN254_TC_IMADS / rate,
                lanes * BN254_TC_INT8_OPS / INT8_OPS_PER_S) * 1e3
    form = ("tensor-core form: IMADs" if tc_ms <= cios_ms
            else "CIOS form: IMADs")
    ms, by = bound(min(cios_ms, tc_ms), lanes * 1024)
    return ms, by, form if by == "operations" else "bytes"


def bn254_latency_ms(latency_s):
    """One Poseidon-BN254 launch's latency bound: every lane's permutation
    is BN254_PERM_DEPTH dependent products of at least L each."""
    return BN254_PERM_DEPTH * latency_s * 1e3


def scan_bound(gate, lanes, rate, latency_s):
    """The interpolation scan of ``gate`` over ``lanes``: (ms, what bounds
    it, form) for the least over the JAX form and the kernel's
    prefix-suffix form against bytes (the intermediates, the values the
    active steps read and the point in, ev and pr out; the schedule's 20 B
    a cell), and each form's chain of dependent products x L in ms."""
    x, _, col, log_seg = km.scan_cells(gate.schedule)
    chunks, active = len(col) >> log_seg, int((col >= 0).sum())
    ea_imads = EA_MUL_PRODUCTS * GL_MUL_IMADS
    scan_ms = lanes * active * SCAN_STEP_IMADS / rate * 1e3
    seg_imads = ((1 << log_seg) * (4 * GL_MUL_IMADS + (2 * log_seg + 2)
                                   * ea_imads) + 3 * ea_imads)
    seg_ms = lanes * chunks * seg_imads / rate * 1e3
    nbytes = 64 * lanes * (2 * (chunks - 1) + active + 1 + 2 * chunks)
    ms, by = bound(min(scan_ms, seg_ms), nbytes + 20 * len(x))
    form = ("JAX form: IMADs" if scan_ms <= seg_ms
            else "prefix-suffix form: IMADs") if by == "operations" else "bytes"
    deg = gate.schedule[3].shape[0]
    chains = {"scan_latency_ms": deg * EA_MUL_DEPTH * latency_s * 1e3,
              "prefix_suffix_latency_ms":
                  (log_seg + 3) * EA_MUL_DEPTH * latency_s * 1e3}
    return ms, by, form, chains


def transcript_bound(n_perms, batch, nbytes, rate, latency_s):
    """(ms, what bounds it, which bound) of the scan: the larger of its IMAD
    throughput bound and its latency bound n_perms x depth x latency."""
    imad_ms = n_perms * batch * GL_PERM_IMADS / rate * 1e3
    lat_ms = n_perms * GL_PERM_DEPTH * latency_s * 1e3
    ms, by = bound(max(imad_ms, lat_ms), nbytes)
    if by == "bytes":
        return ms, by, "bytes"
    return ms, by, ("latency of dependent products" if lat_ms >= imad_ms
                    else "IMAD throughput")


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


def timed_once(fn):
    """(fn(), its device time in ms): one call, no warm-up."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def graph_ms(fn, iters=GRAPH_LAUNCHES):
    """Device time of one fn() inside a CUDA graph of ``iters`` calls (the
    mean of 3 replays, after a warm-up call and a first replay): the time
    without the host's launch pace, as the compiled verifier runs it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # constant tables and allocations before the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return float(np.mean(times))


def random_bn_states(n, rng):
    """(n, 4, 16) canonical Montgomery limbs; lane 0 holds 0, 1, p-1, 2."""
    vals = rng.integers(0, 1 << 16, size=(n, 4, 16), dtype=np.int64)
    vals[..., 15] &= 0x1FFF  # < 2^253 < p
    edge = [0, 1, bn254.P - 1, 2]
    vals[0] = np.asarray([bn254.int_to_limbs(v) for v in edge], dtype=np.int64)
    return torch.as_tensor(vals)


def check_bn254_kernels(dev, rng, lanes_list, timed_lanes):
    """Both Poseidon-BN254 kernels bit-exact against the plain version at
    each lane count and on a strided input; at each of ``timed_lanes``, the
    kernels' times in turns (A, CIOS, CIOS, A) and each plain version's
    time, keyed by the lane count."""
    err = {"a": 0, "cios": 0}
    cases = [random_bn_states(n, rng).to(dev) for n in lanes_list]
    cases.append(random_bn_states(1000, rng).to(dev).reshape(40, 25, 4, 16)
                 .transpose(0, 1))  # strided
    for st in cases:
        want = kb.permute_plain(st.contiguous())
        for key, kernel in (("a", kb), ("cios", kc)):
            got = kernel.permute(st)
            torch.cuda.synchronize()
            err[key] = max(err[key], int((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"poseidon_bn254 kernel {key} differs at "
                                     f"shape {tuple(st.shape)}")
    ms, plain = {}, {}
    for lanes in timed_lanes:
        st = random_bn_states(lanes, rng).to(dev)
        turns = [("a", kb), ("cios", kc), ("cios", kc), ("a", kb)]
        ms[lanes] = {"a": [], "cios": []}
        for key, kernel in turns:
            ms[lanes][key].append(cuda_ms(lambda: kernel.permute(st), 20))
        plain[lanes] = {"a": cuda_ms(lambda: kb.permute_plain(st), 2),
                        "cios": cuda_ms(lambda: kc.permute_plain(st), 2)}
    return err, ms, plain


def transcript_inputs(dev, rng, schedule, batch):
    obs_np = rng.integers(0, gl.P, size=(batch, schedule.n_obs),
                          dtype=np.uint64)
    obs_np[0, :3] = [0, 1, gl.P - 1]
    obs = gl.split_u64(obs_np, dev)
    pi = gl.split_u64(rng.integers(0, gl.P, size=(batch, 4),
                                   dtype=np.uint64), dev)
    return obs, pi


def check_transcript_kernel(dev, rng, specs):
    """The transcript kernel bit-exact against the plain scan at each batch
    of TRANSCRIPT_BATCHES on each spec's schedule (the first lanes of one
    input, whose lanes are independent, so one plain scan covers them all).
    On the first (step) schedule, the time of that one plain scan (bound by
    host launches, so its batch barely matters) and the kernel's time at
    B=STEP_BATCH on the first lanes of the same input."""
    err = 0
    for spec in specs:
        schedule = chal.build_schedule(spec)
        obs, pi = transcript_inputs(dev, rng, schedule, max(TRANSCRIPT_BATCHES))
        want, ms = timed_once(lambda: kt.run_transcript_plain(schedule, obs, pi))
        if spec is specs[0]:
            plain_ms = ms
            timed = (schedule, tuple(t[:STEP_BATCH] for t in obs),
                     tuple(t[:STEP_BATCH] for t in pi))
        for batch in TRANSCRIPT_BATCHES:
            got = kt.run_transcript_kernel(
                schedule, tuple(t[:batch] for t in obs),
                tuple(t[:batch] for t in pi))
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                err = max(err, int((g - w[:, :batch]).abs().max()))
                if not torch.equal(g, w[:, :batch]):
                    raise AssertionError(
                        f"transcript kernel differs from the plain scan at "
                        f"B={batch}, {schedule.n_perms} permutations")
    schedule, obs, pi = timed
    ms = cuda_ms(lambda: kt.run_transcript_kernel(schedule, obs, pi), 20)
    # bytes at the wrapper: obs and pi in, the states out, each a GL pair
    nbytes = 2 * 8 * STEP_BATCH * (schedule.n_obs + 4 + schedule.n_perms * 12)
    return err, ms, plain_ms, schedule.n_perms, nbytes


def gl_mul_latency(dev):
    """Seconds of one dependent Goldilocks product on the card, from the
    one-thread chain probe of csrc/poseidon_gl_transcript.cu: the time of
    a chain of n2 products less that of n1, over n2 - n1."""
    x0, n1, n2 = 3, 1 << 14, 1 << 17
    got = int(kt.mul_chain(x0, n2, dev).item()) % (1 << 64)
    if got != pow(x0, pow(2, n2, gl.P - 1), gl.P):
        raise AssertionError("gl_mul chain probe computes a wrong value")
    t1 = min(cuda_ms(lambda: kt.mul_chain(x0, n1, dev), 3) for _ in range(3))
    t2 = min(cuda_ms(lambda: kt.mul_chain(x0, n2, dev), 3) for _ in range(3))
    return (t2 - t1) / 1e3 / (n2 - n1)


def qe_values(shape, rng, dev, zero_lanes=0):
    """Random QE values of ``shape`` on ``dev``; the first elements take
    every pair of GL_EDGE but (0, 0), the last ``zero_lanes`` are 0."""
    c = [np.array(rng.integers(0, gl.P, size=shape, dtype=np.uint64))
         for _ in range(2)]
    f0, f1 = c[0].reshape(-1), c[1].reshape(-1)
    pairs = [(a, b) for a in GL_EDGE for b in GL_EDGE if a or b][:f0.size]
    for i, (a, b) in enumerate(pairs):
        f0[i], f1[i] = a, b
    if zero_lanes:
        f0[-zero_lanes:] = 0
        f1[-zero_lanes:] = 0
    return tuple(tuple(t.reshape(shape) for t in gl.split_u64(v, dev))
                 for v in c)


def strided(a):
    """The same QE value through transposed, non-contiguous planes."""
    return tuple(tuple(t.T.contiguous().T for t in c) for c in a)


def inv_zeros(n):
    """The elements an inverse case holds 0 at: the first, the 32nd (the
    last lane of a warp at K = 1), the last, and from 512 elements on all of
    [256, 512), a whole warp at every K of PER_THREAD."""
    zeros = {0, min(31, n - 1), n - 1}
    if n >= 512:
        zeros.update(range(256, 512))
    return sorted(zeros)


def inv_values(shape, rng, dev):
    """qe_values of ``shape`` (the edge pairs first) with 0 at inv_zeros."""
    a = qe_values(shape, rng, dev)
    zeros = torch.as_tensor(inv_zeros(math.prod(shape)), device=dev)
    for c in a:
        for t in c:
            t.view(-1)[zeros] = 0
    return a


def check_chain_kernels(dev, rng):
    """The QE Horner, powers and inverse kernels and the public-input sponge
    bit-exact against their plain versions at every case of HORNER_CASES,
    POWERS_CASES, INV_CASES and PI_HASH_N (B = 1 and STEP_BATCH), on
    strided input, and Horner and powers at every group width at each of
    GROUP_CASES; returns each one's largest |kernel - plain| (0)."""
    err = {"qe_horner": 0, "qe_powers": 0, "qe_inv": 0,
           "poseidon_gl_pi_hash": 0}

    def hold(name, got, want, what):
        """got, want: tuples of GL pairs."""
        torch.cuda.synchronize()
        for g, w in zip((t for c in got for t in c), (t for c in want for t in c)):
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at {what}")
            if g.numel():
                err[name] = max(err[name], int((g - w).abs().max()))

    def x_values(shape):
        return qe_values(shape, rng, dev, zero_lanes=int(math.prod(shape) > 1))

    for t_shape, x_shape in HORNER_CASES:
        terms, x = qe_values(t_shape, rng, dev), x_values(x_shape)
        hold("qe_horner", kq.horner(terms, x), qe.horner_plain(terms, x),
             f"terms {t_shape}, x {x_shape}")
    terms, x = strided(qe_values((256, 145), rng, dev)), qe_values((256,), rng, dev)
    hold("qe_horner", kq.horner(terms, x), qe.horner_plain(terms, x),
         "strided terms (256, 145)")
    for lanes, n in POWERS_CASES:
        x = x_values((lanes,))
        hold("qe_powers", kq.powers(x, n), qe.powers_plain(x, n),
             f"{lanes} lanes, n = {n}")
    x = tuple(tuple(t.T for t in c) for c in qe_values((16, 16), rng, dev))
    hold("qe_powers", kq.powers(x, 6), qe.powers_plain(x, 6),
         "strided x (16, 16)")
    for lanes, n in GROUP_CASES:
        terms, x = qe_values((lanes, n), rng, dev), x_values((lanes,))
        want_h, want_p = qe.horner_plain(terms, x), qe.powers_plain(x, n)
        for g in GROUPS:
            hold("qe_horner", kq.horner(terms, x, group=g), want_h,
                 f"({lanes}, {n}), G = {g}")
            hold("qe_powers", kq.powers(x, n, group=g), want_p,
                 f"{lanes} lanes, n = {n}, G = {g}")
    for shape in INV_CASES:
        a = inv_values(shape, rng, dev)
        want = qe.inv_plain(a)
        zeros = torch.as_tensor(inv_zeros(math.prod(shape)), device=dev)
        for k in [None] + PER_THREAD:
            got = kq.inv(a, per_thread=k)
            hold("qe_inv", got, want, f"{shape}, K = {k or 'the rule'}")
            if any(t.reshape(-1)[zeros].any() for c in got for t in c):
                raise AssertionError(f"qe_inv: 0 does not give 0 at {shape}")
    views = {"transposed (28, 256)": strided(qe_values((28, 256), rng, dev)),
             "broadcast (256, 28, 1) to (256, 28, 16)": tuple(
                 tuple(t.expand(256, 28, 16) for t in c)
                 for c in qe_values((256, 28, 1), rng, dev)),
             "even columns of (256, 28, 32)": tuple(
                 tuple(t[..., ::2] for t in c)
                 for c in qe_values((256, 28, 32), rng, dev))}
    for what, a in views.items():
        dense = tuple(tuple(t.contiguous() for t in c) for c in a)
        hold("qe_inv", kq.inv(a), kq.inv(dense), f"strided: {what}")
        hold("qe_inv", kq.inv(a), qe.inv_plain(a), f"strided: {what}")
    for n in PI_HASH_N:
        for batch in (1, STEP_BATCH):
            vals = rng.integers(0, gl.P, size=(batch, n), dtype=np.uint64)
            flat = vals.reshape(-1)
            flat[:min(flat.size, 3)] = [0, 1, gl.P - 1][:flat.size]
            inputs = gl.split_u64(vals, dev)
            hold("poseidon_gl_pi_hash", (pgl.hash_no_pad(inputs),),
                 (pgl.hash_no_pad_plain(inputs),), f"n = {n}, B = {batch}")
    return err


def inv_bound(n_el, k, rate):
    """(ms, what bounds it) of the inverse of n_el elements in its batch
    form, K elements a thread: 64 B an element against the elements' IMADs
    and one inversion a warp of 32 K elements."""
    warps = -(-n_el // (32 * k))
    imads = n_el * QE_INV_ELEMENT_IMADS + warps * QE_INV_WARP_IMADS
    return bound(imads / rate * 1e3, 64 * n_el)


def inv_depth(k):
    """Dependent products of a warp of the batch inverse, K elements a
    thread: the norm 2, the lane's running product K - 1, the scans 5, the
    inversion 73 (64 squarings, 9 products), q[K - 1]^-1 2, the walk back
    K - 1 and an element's N^-1 and scaling 2."""
    return 2 + (k - 1) + 5 + 73 + 2 + (k - 1) + 2


def chain_call(kernel, shape, arg, rng, dev):
    """(kernel(group) -> launch, plain -> launch, lanes, n, IMADs, bytes) of
    one call of CHAIN_CALLS: a Horner or powers step is a QE product by a
    fixed x (W x1 made once a lane); each operand is read once, the output
    written once."""
    if kernel == "qe_horner":
        terms, x = qe_values(shape, rng, dev), qe_values(arg, rng, dev)
        n = shape[-1]
        lanes = math.prod(torch.broadcast_shapes(shape[:-1], arg))
        return (lambda g=None: (lambda: kq.horner(terms, x, group=g)),
                lambda: qe.horner_plain(terms, x), lanes, n,
                lanes * (n * QE_STEP_IMADS + 8),
                32 * (math.prod(shape) + math.prod(arg) + lanes))
    x, n = qe_values(shape, rng, dev), arg
    lanes = math.prod(shape)
    return (lambda g=None: (lambda: kq.powers(x, n, group=g)),
            lambda: qe.powers_plain(x, n), lanes, n,
            lanes * ((n - 1) * QE_STEP_IMADS + 8), 32 * lanes * (n + 1))


def time_chain_kernels(dev, rng, rate, latency_s):
    """Horner and powers at each of CHAIN_CALLS, the inverse and the sponge
    at their largest shapes on the main path (step, B=STEP_BATCH): each
    kernel's time in a CUDA graph at the group width its wrapper picks and
    at every other width up to n, its bound, the latency of its old
    one-thread chain (n x L) and of the split chain (chain_depth x L); the
    plain version's time in a graph and eagerly at the largest shape; the
    sum over one verification's calls."""
    B = STEP_BATCH
    out = {"qe_horner": {"at_main_path_shapes": []},
           "qe_powers": {"at_main_path_shapes": []}}
    for kernel, shape, arg, calls in CHAIN_CALLS:
        launch, plain, lanes, n, imads, nbytes = chain_call(kernel, shape, arg,
                                                            rng, dev)
        group = kq.chain_group(lanes, n)
        ms, by = bound(imads / rate * 1e3, nbytes)
        row = {"shape": (f"terms {shape}, x {arg}" if kernel == "qe_horner"
                         else f"x {shape}, n = {arg}"),
               "lanes": lanes, "n": n, "calls": calls, "group": group,
               "ms": graph_ms(launch()), "bound_ms": ms, "bound_by": by,
               "group_ms": {g: graph_ms(launch(g)) for g in GROUPS
                            if g <= max(n, 1)},
               "scan_latency_ms": n * latency_s * 1e3,
               "chain_depth": kq.chain_depth(n, group),
               "split_latency_ms": kq.chain_depth(n, group) * latency_s * 1e3}
        if shape == (B, 258) or arg == 258:  # the largest
            row["plain_ms"] = graph_ms(plain, 2)
            row["plain_eager_ms"] = cuda_ms(plain, 2)
            out[kernel].update({k: v for k, v in row.items()
                                if k != "group_ms"})
        out[kernel]["at_main_path_shapes"].append(row)
    for kernel in ("qe_horner", "qe_powers"):
        out[kernel]["ms_one_verification"] = sum(
            r["ms"] * r["calls"] for r in out[kernel]["at_main_path_shapes"])
        out[kernel]["bound_ms_one_verification"] = sum(
            r["bound_ms"] * r["calls"]
            for r in out[kernel]["at_main_path_shapes"])
    out["qe_inv"] = {"at_main_path_shapes": []}
    for shape, calls in INV_CALLS:
        a = qe_values(shape, rng, dev)
        n_el = math.prod(shape)
        k = kq.inv_per_thread(n_el)
        ms, by = inv_bound(n_el, k, rate)
        row = {"shape": f"{shape}", "elements": n_el, "calls": calls,
               "per_thread": k, "ms": graph_ms(lambda: kq.inv(a)),
               "bound_ms": ms, "bound_by": by,
               "bound_one_inversion_an_element_ms": bound(
                   n_el * QE_INV_ELEMENT_FORM_IMADS / rate * 1e3,
                   64 * n_el)[0],
               "per_thread_ms": {j: graph_ms(lambda: kq.inv(a, per_thread=j))
                                 for j in PER_THREAD},
               "scan_latency_ms": QE_INV_DEPTH * latency_s * 1e3,
               "batch_depth": inv_depth(k),
               "batch_latency_ms": inv_depth(k) * latency_s * 1e3}
        if shape == INV_CALLS[-1][0]:  # the largest
            row["plain_ms"] = graph_ms(lambda: qe.inv_plain(a), 2)
            row["plain_eager_ms"] = cuda_ms(lambda: qe.inv_plain(a), 2)
            out["qe_inv"].update({key: v for key, v in row.items()
                                  if key != "per_thread_ms"})
        out["qe_inv"]["at_main_path_shapes"].append(row)
    rows = out["qe_inv"]["at_main_path_shapes"]
    out["qe_inv"]["ms_one_verification"] = sum(r["ms"] * r["calls"]
                                               for r in rows)
    out["qe_inv"]["bound_ms_one_verification"] = sum(
        r["bound_ms"] * r["calls"] for r in rows)
    pi = gl.split_u64(rng.integers(0, gl.P, size=(B, 36), dtype=np.uint64),
                      dev)
    n_perms = -(-36 // 8)
    ms, by, form = transcript_bound(n_perms, B, 16 * B * (36 + 4), rate,
                                    latency_s)
    out["poseidon_gl_pi_hash"] = {
        "shape": f"({B}, 36) inputs, {n_perms} permutations",
        "ms": graph_ms(lambda: kt.hash_no_pad_kernel(pi)),
        "plain_ms": graph_ms(lambda: pgl.hash_no_pad_plain(pi), 2),
        "plain_eager_ms": cuda_ms(lambda: pgl.hash_no_pad_plain(pi), 2),
        "bound_ms": ms, "bound_by": by, "bound_form": form}
    return out


def gl_values(shape, rng, dev):
    """Random GL values of ``shape``; the first elements take GL_EDGE."""
    return qe_values(shape, rng, dev)[0]


@contextlib.contextmanager
def plain_products():
    """Every Goldilocks and QE product and the interpolation scan take their
    plain versions on the card too: for the plain versions' times only."""
    saved = gl.mul_kernels
    gl.mul_kernels = lambda t: None
    try:
        yield
    finally:
        gl.mul_kernels = saved


def on_cpu(x):
    return torch.utils._pytree.tree_map(lambda t: t.cpu(), x)


def coset_gate(spec):
    gate, = [g for g in spec.gates()
             if isinstance(g, G.CosetInterpolationGate)]
    return gate


def scan_inputs(gate, lanes, rng, dev, zero_t=False):
    """The interpolation scan's arguments at ``lanes``: random EA
    intermediates, values and point (the edge pairs first, in both halves),
    the gate's own host schedule.  With ``zero_t`` the point of lane i is
    the domain point of the i-th active (step, chunk), chunk by chunk, in
    its first coordinate and 0 in the others: that step's t is 0."""
    ni = gate.num_intermediates

    def ea(shape):
        return (qe_values(shape, rng, dev), qe_values(shape, rng, dev))

    pt = ea((lanes, 1))
    if zero_t:
        xs, _, _, active = gate.schedule
        x = xs[0].astype(np.uint64) | (xs[1].astype(np.uint64) << np.uint64(32))
        points = x.T[active.T][:lanes]
        n = len(points)
        for plane, value in zip(pt[0][0], gl.split_u64(points, dev)):
            plane.view(-1)[:n] = value
        for value in (pt[0][1], pt[1][0], pt[1][1]):
            for plane in value:
                plane.view(-1)[:n] = 0
    return (ea((lanes, ni)), ea((lanes, ni)), ea((lanes, gate.num_points)),
            pt, gate.schedule)


def bits_calls(spec):
    """The bit-selected products by a constant of one verification of
    ``spec`` (fields/goldilocks.mul_const_bits in fri/verify.py): (call, a
    given, c, off, table): subgroup_x, a = 1, c the group generator, the
    lde_bits low bits of the query index; each reduction round's
    cosetStart, a = the round's subgroup_x, c = 1, its arity_bits above the
    earlier rounds'."""
    lde = spec.lde_bits
    calls = [("subgroup_x", False, gl.MULTIPLICATIVE_GROUP_GENERATOR, 0,
              gl.bitrev_powers(gl.primitive_root_of_unity(lde), lde))]
    off = 0
    for j, bits in enumerate(spec.reduction_arity_bits):
        g_inv = pow(gl.primitive_root_of_unity(bits), (1 << bits) - 1, gl.P)
        calls.append((f"cosetStart, round {j}", True, 1, off,
                      gl.bitrev_powers(g_inv, bits)))
        off += bits
    return calls


def query_indices(shape, bits, rng, dev):
    """GL indices below 2^bits (a 64-bit canonical value for bits = 64);
    the first take 0, 1 and the largest."""
    top = gl.P if bits == 64 else 1 << bits
    v = np.array(rng.integers(0, top, size=shape, dtype=np.uint64))
    flat = v.reshape(-1)
    edge = [0, 1, top - 1][:flat.size]
    flat[:len(edge)] = edge
    return tuple(t.reshape(shape) for t in gl.split_u64(v, dev))


def bits_loop(a, c, bits, table):
    """The loop that the bit-selected product replaced in fri/verify.py, on
    the kernels: a product by a constant and a select a bit (``bits`` made
    before, as the loop found them), then the product by a and by c."""
    prod = (torch.ones_like(bits[0]), torch.zeros_like(bits[0]))
    for i in reversed(range(len(table))):
        prod = gl.select(bits[i].bool(), gl.mul_const(prod, table[i]), prod)
    if a is not None:
        prod = gl.mul(prod, a)
    return gl.mul_const(prod, c)


def check_product_kernels(dev, rng, specs):
    """The product kernels bit-exact against their plain versions at every
    shape of PRODUCT_SHAPES, on each broadcast pattern of the call sites,
    strided views and an empty lead shape, for the constants MUL_CONSTS;
    the interpolation scan on the gate of each spec ({fixture: spec}) at
    SCAN_LANES, and with points equal to domain points (a zero t), against
    the plain scan on CPU copies.  Returns each one's largest |kernel -
    plain| (0)."""
    err = {"gl_mul": 0, "gl_mul_const": 0, "qe_mul": 0,
           "coset_interp_scan": 0}

    def hold(name, got, want, what, launched, before):
        torch.cuda.synchronize()
        leaves = torch.utils._pytree.tree_leaves
        for g, w in zip(leaves(got), leaves(want)):
            g = g.to(w.device)
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at {what}")
            if g.numel():
                err[name] = max(err[name], int((g - w).abs().max()))
        counter = getattr(km, name)
        if counter.launches - before != launched:
            raise AssertionError(f"{name} at {what}: "
                                 f"{counter.launches - before} launches, "
                                 f"expected {launched}")

    def run(name, fn, want_fn, what, launched=1):
        before = getattr(km, name).launches
        hold(name, fn(), want_fn(), what, launched, before)

    for shape in PRODUCT_SHAPES:
        a, b = gl_values(shape, rng, dev), gl_values(shape, rng, dev)
        run("gl_mul", lambda: gl.mul(a, b), lambda: gl.mul_plain(a, b),
            f"{shape}")
        for c in MUL_CONSTS:
            run("gl_mul_const", lambda: gl.mul_const(a, c),
                lambda: gl.mul_const_plain(a, c), f"{shape}, c = {c}",
                int(c not in (0, 1)))
        x, y, z = (qe_values(shape, rng, dev) for _ in range(3))
        run("qe_mul", lambda: qe.mul(x, y), lambda: qe.mul_plain(x, y),
            f"{shape}")
        run("qe_mul", lambda: qe.mul_add(x, y, z),
            lambda: qe.mul_add_plain(x, y, z), f"{shape}, a b + c")
    wires = qe_values((STEP_BATCH, 135), rng, dev)
    pairs = qe_values((STEP_BATCH, 28, 16), rng, dev)
    patterns = [
        ("(B, 1) x (B, n)", qe_values((STEP_BATCH, 1), rng, dev),
         qe_values((STEP_BATCH, 80), rng, dev)),
        ("(n,) x (B, n)", qe_values((80,), rng, dev),
         qe_values((STEP_BATCH, 80), rng, dev)),
        ("(B, k, 1) x (B, k, n)", qe_values((STEP_BATCH, 28, 1), rng, dev),
         qe_values((STEP_BATCH, 28, 16), rng, dev)),
        ("() x (B, n)", qe_values((), rng, dev),
         qe_values((STEP_BATCH, 80), rng, dev)),
        ("wire columns", qe.index(wires, (Ellipsis, 3)),
         qe.index(wires, (Ellipsis, 100))),
        ("wire slices", qe.index(wires, (Ellipsis, slice(1, 81, 4))),
         qe.index(wires, (Ellipsis, slice(2, 82, 4)))),
        ("even x odd columns", qe.index(pairs, (Ellipsis, slice(0, None, 2))),
         qe.index(pairs, (Ellipsis, slice(1, None, 2)))),
        ("transposed", strided(qe_values((STEP_BATCH, 80), rng, dev)),
         qe_values((STEP_BATCH, 80), rng, dev)),
        ("empty (B, 0)", qe_values((STEP_BATCH, 0), rng, dev),
         qe_values((STEP_BATCH, 0), rng, dev)),
    ]
    for what, x, y in patterns:
        lead = tuple(torch.broadcast_shapes(x[0][0].shape, y[0][0].shape))
        z = qe_values(lead, rng, dev)
        n = int(math.prod(lead) > 0)
        run("gl_mul", lambda: gl.mul(x[0], y[1]),
            lambda: gl.mul_plain(x[0], y[1]), what, n)
        run("gl_mul_const", lambda: gl.mul_const(x[1], gl.DTH_ROOT),
            lambda: gl.mul_const_plain(x[1], gl.DTH_ROOT), what, n)
        run("qe_mul", lambda: qe.mul(x, y), lambda: qe.mul_plain(x, y),
            what, n)
        run("qe_mul", lambda: qe.mul_add(x, y, z),
            lambda: qe.mul_add_plain(x, y, z), f"{what}, a b + c", n)
    Q = specs["step"].num_query_rounds
    lde = specs["step"].lde_bits
    bits_cases = []
    for fixture, spec in specs.items():
        for call, has_a, c, off, table in bits_calls(spec):
            shape = (STEP_BATCH, spec.num_query_rounds)
            bits_cases.append((f"{fixture}'s {call} at {shape}",
                               gl_values(shape, rng, dev) if has_a else None,
                               c, query_indices(shape, spec.lde_bits, rng,
                                                dev), off, table))
    sub = bits_calls(specs["step"])[0]
    for lanes in BITS_LANES:
        bits_cases.append((f"subgroup_x at {lanes} lanes", None, sub[2],
                           query_indices((lanes,), lde, rng, dev), 0, sub[4]))
    table = [int(t) for t in rng.integers(0, gl.P, size=64, dtype=np.uint64)]
    idx64 = query_indices((STEP_BATCH, Q), 64, rng, dev)
    x = gl_values((STEP_BATCH, Q), rng, dev)
    idx_t = tuple(t.T for t in query_indices((Q, STEP_BATCH), lde, rng, dev))
    x_t = tuple(t.T for t in gl_values((Q, STEP_BATCH), rng, dev))
    bits_cases += [
        ("bits 48 to 63 of 64-bit indices", x, 7, idx64, 48, table[:16]),
        ("all 64 bits", x, gl.DTH_ROOT, idx64, 0, table),
        ("5 bits at 3", None, gl.DTH_ROOT, idx64, 3, table[:5]),
        ("1 bit at 63", x, 1, idx64, 63, table[:1]),
        ("c = 0", x, 0, idx64, 0, table[:4]),
        ("transposed index and a", x_t, 1, idx_t, 4, sub[4][:4]),
        ("a (B, 1) against the index (B, Q)",
         gl_values((STEP_BATCH, 1), rng, dev), 1, idx64, 0, table[:4]),
        ("empty (B, 0)", None, 7,
         query_indices((STEP_BATCH, 0), lde, rng, dev), 0, table[:4])]
    for what, a, c, idx, off, table in bits_cases:
        n = int(idx[0].numel() > 0)
        run("gl_mul_const", lambda: gl.mul_const_bits(a, c, idx, off, table),
            lambda: gl.mul_const_bits_plain(a, c, idx, off, table),
            f"bit-selected: {what}", n)
        if what.startswith("transposed"):
            dense = (tuple(t.contiguous() for t in a),
                     tuple(t.contiguous() for t in idx))
            run("gl_mul_const",
                lambda: gl.mul_const_bits(a, c, idx, off, table),
                lambda: gl.mul_const_bits(dense[0], c, dense[1], off, table),
                f"bit-selected: {what} against contiguous copies", 2)
    for fixture, spec in specs.items():
        gate = coset_gate(spec)
        for lanes, zero_t in [(n, False) for n in SCAN_LANES] + [
                (STEP_BATCH, True), (33, True)]:
            args = scan_inputs(gate, lanes, rng, dev, zero_t)
            run("coset_interp_scan", lambda: G.coset_interp_scan(*args),
                lambda: G.coset_interp_scan_plain(
                    *G.coset_interp_scan_operands(*on_cpu(args[:4]),
                                                  gate.schedule)),
                f"{fixture}'s gate, {lanes} lanes"
                + (", points on the domain" if zero_t else ""))
    return err


def time_product_kernels(dev, rng, rate, latency_s, spec):
    """Each product kernel at its largest main-path shape and the scan on
    ``spec``'s gate at B=STEP_BATCH: its time in a CUDA graph, its plain
    version's in a graph and eagerly (every product plain), its bound and,
    for the scan, its two forms' bounds and the latency of their chains."""
    B = STEP_BATCH
    a, b = (gl_values((B, 28, 16), rng, dev) for _ in range(2))
    c_arg = gl_values((B, 44), rng, dev)
    pairs = qe_values((B, 28, 16, 16), rng, dev)
    x, y = (qe.index(pairs, (Ellipsis, slice(k, None, 2))) for k in (0, 1))
    n_gl, n_c, n_qe = B * 28 * 16, B * 44, B * 28 * 16 * 8
    gate = coset_gate(spec)
    args = scan_inputs(gate, B, rng, dev)
    operands = G.coset_interp_scan_operands(*args)
    C, deg = 1 + gate.num_intermediates, gate.degree
    steps = int(gate.schedule[3].sum())  # the active (step, chunk) pairs
    scan_ms, scan_by, scan_form, scan_chains = scan_bound(gate, B, rate,
                                                          latency_s)
    cases = {
        # name: (kernel, plain, shape, IMADs, bytes); the bytes of each
        # input read once and each output written once
        "gl_mul": (lambda: gl.mul(a, b), lambda: gl.mul_plain(a, b),
                   f"({B}, 28, 16) x ({B}, 28, 16)", n_gl * GL_MUL_IMADS,
                   48 * n_gl),
        "gl_mul_const": (lambda: gl.mul_const(c_arg, gl.DTH_ROOT),
                         lambda: gl.mul_const_plain(c_arg, gl.DTH_ROOT),
                         f"({B}, 44) x DTH_ROOT", n_c * GL_MUL_IMADS,
                         32 * n_c),
        "qe_mul": (lambda: qe.mul(x, y), lambda: qe.mul_plain(x, y),
                   f"even x odd columns of ({B}, 28, 16, 16)",
                   n_qe * QE_MUL_IMADS, 96 * n_qe),
        # the bound of scan_bound
        "coset_interp_scan": (
            lambda: G.coset_interp_scan(*args),
            lambda: G.coset_interp_scan_plain(*operands),
            f"{B} lanes x {C} chunks, {deg} steps ({steps} active)",
            None, None),
    }
    out = {}
    for name, (kern, plain, shape, imads, nbytes) in cases.items():
        ms, by = ((scan_ms, scan_by) if imads is None
                  else bound(imads / rate * 1e3, nbytes))
        with plain_products():
            plain_ms = graph_ms(plain, 2)
            plain_eager_ms = cuda_ms(plain, 2)
        out[name] = {"shape": shape, "ms": graph_ms(kern),
                     "plain_ms": plain_ms, "plain_eager_ms": plain_eager_ms,
                     "bound_ms": ms, "bound_by": by}
    out["coset_interp_scan"].update(bound_form=scan_form, **scan_chains)
    out["gl_mul_const"]["bits_form"] = time_bits_form(dev, rng, rate, spec)
    return out


def time_bits_form(dev, rng, rate, spec):
    """The bit-selected product at each of its calls in a verification of
    ``spec`` at B=STEP_BATCH, in a CUDA graph, beside the loop it replaced
    (a product by a constant and a select a bit) and its bound: the index
    (and a) read once, the output written once, against the products this
    run's indices select and those by a and c."""
    B, Q = STEP_BATCH, spec.num_query_rounds
    idx = query_indices((B, Q), spec.lde_bits, rng, dev)
    idx_np = gl.join_u64(idx)
    x = gl_values((B, Q), rng, dev)
    bits = gl.to_bits(idx, 64)
    rows = []
    for call, has_a, c, off, table in bits_calls(spec):
        a = x if has_a else None
        n = len(table)
        selected = sum(
            int(((idx_np >> np.uint64(off + i)) & np.uint64(1)).sum())
            for i in range(n))
        products = selected + B * Q * (int(has_a) + int(c != 1))
        ms, by = bound(products * GL_MUL_IMADS / rate * 1e3,
                       (32 + 16 * has_a) * B * Q)
        rows.append({
            "call": call, "shape": f"({B}, {Q})", "bits": n, "off": off,
            "ms": graph_ms(lambda: gl.mul_const_bits(a, c, idx, off, table)),
            "loop_ms": graph_ms(lambda: bits_loop(a, c, bits[off:off + n],
                                                  table)),
            "loop_launches": (f"{n + int(has_a) + int(c != 1)} product "
                              f"launches and {n} selects"),
            "bound_ms": ms, "bound_by": by})
    return rows


def fri_inputs(spec, batch, dev):
    """The widened tensor dict of ``batch`` on the card and its query
    indices from the transcript, as verify_device reaches FRI."""
    schedule, d, obs = verifier.prepare(spec, batch, dev)
    states = chal.run_transcript(schedule, obs,
                                 pgl.hash_no_pad(d["public_inputs"]))
    return d, verifier._extract_challenges(schedule, states)["query_indices"]


def per_level_scans(spec, plan, d, x):
    """FRI's hash chains as the port ran them before the chain kernels
    (fri/verify._hash_leaves_scan, _merkle_chain): one single-permutation
    launch an absorb step and tree level, the four initial oracles' levels
    in one launch, plain ops between; 63 launches on step."""
    bits = gl.to_bits(x, 64)[:spec.lde_bits]
    leaf = [fv._hash_leaves_scan(k.leaves(d), k.slot_mask()) if k.steps
            else k.leaves(d)[:, :, 0, 0] for k in plan[:4]]
    init = fv._merkle_chain(torch.stack(leaf, dim=2), d["init_siblings"],
                            [b[..., None].expand(b.shape + (4,))
                             for b in bits], spec.initial_tree_depth)
    roots = list(init.unbind(2))
    for k in plan[4:]:
        roots.append(fv._merkle_chain(
            fv._hash_leaves_scan(k.leaves(d), k.slot_mask()),
            k.siblings(d), bits[k.offset:], k.depth))
    return torch.stack(roots, dim=2)


def chain_bound(plan, lanes, rate, latency_s):
    """(ms, what bounds it, form, latency bound ms, permutations) of every
    chain of ``plan`` over ``lanes`` (proof, query round) pairs: the
    permutations' operations in the least costly form (as bn254_bound)
    against the bytes the function must move: the absorbed slots, a noop
    leaf and the siblings read once (128 B an element), the index's two
    words, the roots written; beside it the longest chain's latency bound."""
    perms = lanes * sum(k.length for k in plan)
    cios_ms = perms * BN254_CIOS_IMADS / rate * 1e3
    tc_ms = max(perms * BN254_TC_IMADS / rate,
                perms * BN254_TC_INT8_OPS / INT8_OPS_PER_S) * 1e3
    read = sum(bin(k.mask).count("1") + (k.steps == 0) + k.depth
               for k in plan)
    nbytes = lanes * ((read + len(plan)) * 128 + 16)
    ms, by = bound(min(cios_ms, tc_ms), nbytes)
    form = ("tensor-core form: IMADs" if tc_ms <= cios_ms
            else "CIOS form: IMADs") if by == "operations" else "bytes"
    latency = max(k.length for k in plan) * bn254_latency_ms(latency_s)
    return ms, by, form, latency, perms


def chain_layout(plan, lanes, form, dev):
    """How a chain-kernel launch of ``form`` (``a`` or ``cios``) lies on the
    card (kernels/fri_merkle.geometry): its slot types and their fill, the
    threads a lane, its blocks, the compiled kernel's registers and
    spills, the blocks and warps an SM holds at once (the runtime's
    occupancy) and the waves."""
    geo = kf.geometry(plan, lanes, form, dev)
    lim = kf.limits(dev, geo.kernel, geo.threads)
    return {"kernel": geo.kernel,
            "slot_types": [[plan[k].name for k in t] for t in geo.types],
            "threads_a_lane": geo.tpl, "threads_a_block": geo.threads,
            "blocks": geo.blocks, "registers": lim["registers"],
            "spill_bytes": lim["spill_bytes"],
            "resident_blocks_an_sm": lim["resident"],
            "resident_warps_an_sm": lim["resident"] * geo.threads // 32,
            "waves": geo.blocks / (lim["sms"] * lim["resident"]),
            "slot_fill": geo.fill(plan)}


def merkle_chain_phase(dev, card, rate, latency_s, cases):
    """FRI's chain kernels on each case's real inputs ({name: (spec,
    batch)}: the widened tensors and the transcript's query indices), in
    turns A, CIOS, CIOS, A: each kernel bit-exact against
    merkle_roots_plain, and so the per-level form (63 launches on step)
    under the same setting; each timed by CUDA events in a graph beside the
    per-level form on the same inputs, with its launch's layout
    (``chain_layout``).  Returns {name: results}."""
    out = {}
    for name, (spec, batch) in cases.items():
        d, x = fri_inputs(spec, batch, dev)
        plan = merkle.merkle_plan(spec)
        lanes = x[0].numel()
        want, plain_ms = timed_once(
            lambda: merkle.merkle_roots_plain(plan, d, x))
        ms, by, form, latency, perms = chain_bound(plan, lanes, rate,
                                                   latency_s)
        r = {"shape": list(want.shape), "chains": lanes * len(plan),
             "permutations": perms, "longest_chain": max(k.length
                                                         for k in plan),
             "plain_ms": plain_ms, "bound_ms": ms, "bound_by": by,
             "bound_form": form, "latency_bound_ms": latency,
             "ms": {"a": [], "cios": []},
             "per_level_ms": {"a": [], "cios": []}, "max_abs_err": 0,
             "layout": {key: chain_layout(plan, lanes, key, dev)
                        for key in ("a", "cios")}}
        for key, lay in r["layout"].items():
            print(f"merkle_chains {name} {key}: kernel {lay['kernel']}, "
                  f"slot types {lay['slot_types']} (fill "
                  f"{lay['slot_fill']:.3f}), threads a lane "
                  f"{lay['threads_a_lane']}, {lay['blocks']} blocks of "
                  f"{lay['threads_a_block']} threads, {lay['registers']} "
                  f"registers, {lay['spill_bytes']} spill bytes, "
                  f"{lay['resident_blocks_an_sm']} resident blocks an SM "
                  f"({lay['resident_warps_an_sm']} warps), "
                  f"{lay['waves']:.3f} waves")
        for impl in ("mxu", "cios", "cios", "mxu"):
            key, counter = CHAIN_FORMS[impl]
            kernel = kernel_launches.counters()[counter]
            with pb.use_impl(impl):
                got = kernel(plan, d, x)
                old = per_level_scans(spec, plan, d, x)
                torch.cuda.synchronize()
                r["max_abs_err"] = max(r["max_abs_err"],
                                       int((got - want).abs().max()))
                for what, roots in (("the chain kernel", got),
                                    ("the per-level form", old)):
                    if not torch.equal(roots, want):
                        raise AssertionError(
                            f"{name} {impl}: {what} differs from "
                            f"merkle_roots_plain in chains "
                            f"{(roots != want).any(-1).nonzero().tolist()[:8]}")
                r["ms"][key].append(graph_ms(lambda: kernel(plan, d, x),
                                             CHAIN_GRAPH_LAUNCHES))
                r["per_level_ms"][key].append(graph_ms(
                    lambda: per_level_scans(spec, plan, d, x),
                    CHAIN_GRAPH_LAUNCHES))
        print(f"merkle_chains {name} ({r['chains']} chains, {perms} "
              f"permutations, the longest {r['longest_chain']}): in turns A, "
              f"CIOS, CIOS, A kernel {r['ms']['a'][0]:.4f}, "
              f"{r['ms']['cios'][0]:.4f}, {r['ms']['cios'][1]:.4f}, "
              f"{r['ms']['a'][1]:.4f} ms, the per-level form "
              f"({PER_LEVEL_BN254_LAUNCHES.get(name.split()[0], '?')} "
              f"launches) {r['per_level_ms']['a'][0]:.4f}, "
              f"{r['per_level_ms']['cios'][0]:.4f}, "
              f"{r['per_level_ms']['cios'][1]:.4f}, "
              f"{r['per_level_ms']['a'][1]:.4f} ms (each in a CUDA graph of "
              f"{CHAIN_GRAPH_LAUNCHES}); plain {plain_ms:.2f} ms, one call; "
              f"bound {ms:.4f} ms ({by}, {form}), latency bound "
              f"{latency:.4f} ms; bit-exact [{card}]")
        out[name] = r
    return out


def ptxas_report():
    """Per kernel: registers, shared memory and spills, from ``ptxas -v``."""
    keep = ("Compiling entry function", "registers", "spill")
    return [line.strip() for line in build.ptxas_log().splitlines()
            if any(k in line for k in keep)]


def decode_block_batch():
    spec, raws, vraw = decode_block_lanes(TESTDATA / "decode_block")
    batch, mask, errors = serde.ingest_batch(spec, [(r, vraw) for r in raws])
    if errors:
        raise AssertionError(f"decode_block lanes quarantined: {errors}")
    return spec, batch, mask


def per_verify(fixture, impl):
    """Each kernel's launches in one verification of ``fixture`` under
    PLONKY2_TPU_PB_IMPL=``impl``: the chain kernel of the setting once, the
    single-permutation Poseidon-BN254 kernels never."""
    used = CHAIN_FORMS[impl][1]
    unused = CHAIN_FORMS["mxu" if impl == "cios" else "cios"][1]
    return {used: CHAIN_KERNEL_LAUNCHES, unused: 0, "poseidon_bn254": 0,
            "poseidon_bn254_cios": 0, "poseidon_gl_transcript": 1,
            "poseidon_gl_pi_hash": PI_HASH_LAUNCHES[fixture], **CHAIN_LAUNCHES,
            **PRODUCT_LAUNCHES[fixture]}


def times(k, *counts):
    """k x the sum of launch-count dicts."""
    return {key: k * sum(c[key] for c in counts) for key in counts[0]}



def main_path(impl, dev, spec_step, batch_step, expected, spec_db, batch_db,
              mask_db):
    """Verify the step and decode_block batches under ``impl`` through
    ``verify_batch``, the compiled cache emptied first so that both keys
    capture their graphs here; returns the verdicts, the launch counts of
    this path alone and the first-call wall (warm-up and capture included)."""
    with pb.use_impl(impl):
        verifier.compiled_verifier.cache_clear()
        torch.cuda.synchronize()
        kernel_launches.reset()
        t0 = time.perf_counter()
        got_step = verifier.verify_batch(spec_step, batch_step, device=dev)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches_step = kernel_launches.read()
        got_db = verifier.verify_batch(spec_db, batch_db, valid_mask=mask_db,
                                       device=dev, diagnostics=True)
        launches = kernel_launches.read()
    if not np.array_equal(got_step, expected):
        bad_lanes = np.nonzero(got_step != expected)[0].tolist()
        raise AssertionError(f"{impl}: step batch wrong in lanes {bad_lanes}")
    if got_db["verdict"].tolist() != DECODE_EXPECTED:
        raise AssertionError(f"{impl}: decode_block verdicts {got_db}")
    want_step = times(CAPTURE_RUNS, per_verify("step", impl))
    want = times(CAPTURE_RUNS, per_verify("step", impl),
                 per_verify("decode_block", impl))
    if launches_step != want_step or launches != want:
        raise AssertionError(f"{impl}: launches {launches} (step "
                             f"{launches_step}), expected {want} (step "
                             f"{want_step})")
    return got_db, launches, launches_step, step_s


def profile_batch(impl, fn):
    """fn() under torch.profiler: (wall s, device kernel and copy events
    seen, device busy s, {kernel: (launches, device s)}).  The CIOS
    kernel's two kernels are also counted apart: its group kernel runs the
    launches below 8448 lanes, its lane kernel the larger ones (the main
    path launches neither since FRI's chain kernels).  The public-input
    sponge is a launch of the transcript kernel and counts under
    poseidon_gl_transcript."""
    names = dict(kernel_launches.DEVICE_NAMES,
                 poseidon_bn254_cios_group="poseidon_bn254_cios_kernel_group",
                 poseidon_bn254_cios_lane="poseidon_bn254_cios_kernel_lane")
    with pb.use_impl(impl):
        return device_kernels(fn, torch.device("cuda", 0), names)


def phase_launches(phase, impl):
    """The kernel launches torch.profiler sees in one replay of ``phase``'s
    graph on step under ``impl``, every kernel of the path named."""
    want = {k: 0 for k in kernel_launches.DEVICE_NAMES}
    for key, n in PHASE_LAUNCHES[phase].items():
        want[CHAIN_FORMS[impl][1] if key == "chains" else key] = n
    return want


def eager(spec, batch, dev, query_shard=None):
    """The eager verify_device's verdict, plonk_ok and fri_ok on the card."""
    schedule, d, obs = verifier.prepare(spec, batch, dev)
    return verifier.verify_device(spec, schedule, d, obs, diagnostics=True,
                                  query_shard=query_shard)


def host(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def wall_s(fn):
    """(fn(), its wall on the host clock, ended by cuda.synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def lane_rejected(lane):
    """The step verdicts with ``lane`` alone False."""
    want = np.ones(STEP_BATCH, bool)
    want[lane] = False
    return want


def back_to_back(dev, what, run, wants):
    """``run()`` issues loads and replays of one key, reading none, and
    returns their (B,) verdict tensors; the stream sleeps first, so the
    first load's copy to the card is still waiting when the next one
    packs.  Fail unless each gives its own ``wants``."""
    torch.cuda.synchronize()
    with torch.cuda.device(dev):
        torch.cuda._sleep(BACK_TO_BACK_SLEEP_CYCLES)
        outs = run()
    for i, (got, want) in enumerate(zip(outs, wants)):
        got = got.cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"{what}, back to back: batch {i} rejects "
                                 f"{np.nonzero(~got)[0].tolist()}, expected "
                                 f"{np.nonzero(~want)[0].tolist()}")
    print(f"{what}: loaded back to back, the first copy to the card held "
          f"back on the stream: each batch gives its own verdicts")


def narrow_inputs(impl, entry, spec, batch, card):
    """Fail unless the entry's graph takes the narrow layout (every static
    input int32, a view of its flat buffer) through a pinned buffer, and
    the bytes copied in a call are the narrow arrays' (slots aligned to
    128 bytes); print them beside the int64 layout's."""
    leaves = verifier._leaves(entry.inputs)
    if any(t.dtype != torch.int32 for _, t in leaves):
        raise AssertionError(f"{impl}: the graph's inputs are not all int32")
    if not entry.staging.is_pinned():
        raise AssertionError(f"{impl}: the staging buffer is not pinned")
    arrays = convert.device_arrays(batch)
    arrays[verifier.OBSERVED] = chal.build_observed_host(spec, batch)
    narrow = sum(a.nbytes for a in arrays.values())
    wide = sum(t.numel() * 8 for _, t in leaves)
    if not narrow <= entry.bytes_in < narrow + 128 * len(arrays):
        raise AssertionError(f"{impl}: {entry.bytes_in} bytes copied in, "
                             f"the narrow arrays hold {narrow}")
    print(f"{impl}: bytes copied in a step B={STEP_BATCH} call: "
          f"{entry.bytes_in} in one copy from a pinned buffer of the same "
          f"size ({narrow} of arrays, {len(leaves)} int32 leaves in "
          f"{len(arrays)} slots; the int64 layout held {wide}) [{card}]")


def compiled_checks(impl, dev, card, spec_step, batch_step, expected,
                    spec_db, batch_db):
    """The compiled verifier under ``impl``, its two keys captured by the
    main path: replay equals eager on both batches; re-fed batches give
    their own verdicts; a malformed batch raises and the graph still works;
    kernel launches inside one replay (torch.profiler) and the busy share;
    the eager and replay walls.  Returns the replay's kernel counts."""
    walls = {}
    with pb.use_impl(impl):
        for name, spec, batch in (("step", spec_step, batch_step),
                                  ("decode_block", spec_db, batch_db)):
            replay = host(verifier.verify_on_device(spec, batch, dev))
            want, walls[name] = wall_s(lambda: host(eager(spec, batch, dev)))
            for key in want:
                if not np.array_equal(replay[key], want[key]):
                    raise AssertionError(f"{impl}: {name} replay {key} "
                                         f"{replay[key]} differs from eager "
                                         f"{want[key]}")
        print(f"{impl}: replay equals eager (verdict, plonk_ok, fri_ok) on "
              f"step B={STEP_BATCH} and decode_block B=4; eager walls, warm: "
              f"step {walls['step']:.3f} s, decode_block "
              f"{walls['decode_block']:.3f} s [{card}]")

        moved = {k: v.copy() for k, v in batch_step.items()}
        for k in moved:
            moved[k][[CORRUPT_LANE, MOVED_LANE]] = \
                batch_step[k][[MOVED_LANE, CORRUPT_LANE]]
        got = verifier.verify_batch(spec_step, moved, device=dev)
        if np.nonzero(~got)[0].tolist() != [MOVED_LANE]:
            raise AssertionError(f"{impl}: refed step batch rejects "
                                 f"{np.nonzero(~got)[0].tolist()}")
        order = {k: v[DECODE_ORDER] for k, v in batch_db.items()}
        got = verifier.verify_batch(spec_db, order, device=dev)
        if got.tolist() != [DECODE_EXPECTED[i] for i in DECODE_ORDER]:
            raise AssertionError(f"{impl}: decode_block in order "
                                 f"{DECODE_ORDER}: {got.tolist()}")

        qkeys = serde.query_axis_keys(spec_step)
        one_round = {k: (v[:, :1] if k in qkeys else v)
                     for k, v in batch_step.items()}
        try:
            verifier.verify_on_device(spec_step, one_round, dev)
            raise AssertionError(f"{impl}: a step batch of one query round "
                                 f"was verified")
        except ValueError as e:
            message = str(e)
        got = verifier.verify_batch(spec_step, batch_step, device=dev)
        if not np.array_equal(got, expected):
            raise AssertionError(f"{impl}: after the malformed batch the "
                                 f"step replay gave another verdict")
        back_to_back(dev, f"{impl}: one entry", lambda: [
            verifier.verify_on_device(spec_step, b, dev)["verdict"]
            for b in (batch_step, moved)],
            [expected, lane_rejected(MOVED_LANE)])
        print(f"{impl}: the same graphs re-fed: step with lane {MOVED_LANE} "
              f"corrupted rejects lane {MOVED_LANE} alone, decode_block in "
              f"order {DECODE_ORDER} gives "
              f"{[DECODE_EXPECTED[i] for i in DECODE_ORDER]}; one query "
              f"round raises ValueError ({message}), and the next replay is "
              f"right")

        replays = [wall_s(lambda: verifier.verify_batch(
            spec_step, batch_step, device=dev))[1] for _ in range(REPLAYS)]
        entry = verifier.compiled_verifier(spec_step, STEP_BATCH, dev, impl)
        narrow_inputs(impl, entry, spec_step, batch_step, card)
        _, d, obs = verifier.prepare(spec_step, batch_step, dev, narrow=True)
        graph_only = [wall_s(lambda: entry(d, obs))[1]
                      for _ in range(REPLAYS)]
    wall, n_dev, busy, per_kernel = profile_batch(impl, lambda: entry(d, obs))
    want = profiled_launches("step", impl)
    got = {k: per_kernel[k][0] for k in want}
    if got != want:
        raise AssertionError(f"{impl}: one replay launched {got}, expected "
                             f"{want}")
    kern = ", ".join(f"{k} {n} launches {t:.6f} s"
                     for k, (n, t) in per_kernel.items() if n)
    print(f"{impl}: step B={STEP_BATCH} eager {walls['step']:.4f} s against "
          f"verify_batch replays {[round(w, 4) for w in replays]} (median "
          f"{np.median(replays):.4f} s, {STEP_BATCH / np.median(replays):.2f} "
          f"proofs/s) and the graph alone on prepared device tensors "
          f"{[round(w, 4) for w in graph_only]} (median "
          f"{np.median(graph_only):.4f} s) [{card}]")
    print(f"{impl}: one replay under torch.profiler: wall {wall:.4f} s, "
          f"{n_dev} device events (with a Poseidon-BN254 launch an absorb "
          f"step and level: {PER_LEVEL_BN254_REPLAY_EVENTS}; with int64 "
          f"inputs: {WIDE_INPUTS_REPLAY_EVENTS}; with the scan's operands "
          f"gathered: "
          f"{GATHERED_SCAN_REPLAY_EVENTS}; with FRI's bit loops: "
          f"{LOOP_PRODUCTS_REPLAY_EVENTS}; with the plain products: "
          f"{PLAIN_PRODUCTS_REPLAY_EVENTS}; with the plain chains too: "
          f"{PLAIN_CHAINS_REPLAY_EVENTS}), device busy {busy:.4f} s "
          f"({busy / wall:.4f} of the wall); {kern} [{card}]")
    return per_kernel, {"wall_s": wall, "device_events": n_dev,
                        "busy_s": busy, "graph_median_s":
                        float(np.median(graph_only))}


def phase_probe(dev, card, spec_step, batch_step, expected):
    """tools/profile_verify's phases and replayed modes on the step batch
    under mxu, cios, cios, mxu: the plonk and fri phase graphs' outputs must
    equal the compiled verifier's plonk_ok and fri_ok on every lane, the
    probes' verdicts ``expected``, and one replay of each phase must launch
    ``phase_launches`` (of the whole graph, ``profiled_launches``).
    Returns each setting's {phase: {kernel: launches in one replay}}."""
    for impl in ("mxu", "cios"):
        total = {k: phase_launches("plonk", impl)[k]
                 + phase_launches("fri", impl)[k]
                 - phase_launches("transcript", impl)[k]
                 for k in kernel_launches.DEVICE_NAMES}
        want = profiled_launches("step", impl)
        if {k: total[k] for k in want} != want:
            raise AssertionError(f"{impl}: the phases' launches {total} do "
                                 f"not add up to a verification's {want}")
    kernels = {}
    for impl in ("mxu", "cios", "cios", "mxu"):
        with pb.use_impl(impl):
            compiled = host(verifier.verify_on_device(spec_step, batch_step,
                                                      dev))
            ph = profile_verify.profile_phases(spec_step, batch_step, dev)
            rp = profile_verify.profile_replayed(spec_step, batch_step, dev)
        out = ph.pop("outputs")
        for key in ("plonk_ok", "fri_ok"):
            for what, got in ((f"the {key[:-3]} phase's graph", out[key]),
                              ("the probe's whole graph",
                               out["verifier"][key])):
                if not np.array_equal(got, compiled[key]):
                    bad = np.nonzero(got != compiled[key])[0].tolist()
                    raise AssertionError(f"{impl}: {what} differs from the "
                                         f"compiled verifier's {key} in "
                                         f"lanes {bad}")
        verdicts = {"phases": out["plonk_ok"] & out["fri_ok"],
                    "replayed": rp.pop("verdicts"),
                    "replayed without the timer": rp.pop("unprobed_verdicts")}
        for what, got in verdicts.items():
            if not np.array_equal(got, expected):
                raise AssertionError(f"{impl}: the probe's {what} verdicts "
                                     f"reject {np.nonzero(~got)[0].tolist()}")
        for phase, r in ph["phases"].items():
            check_launches(f"{impl}: one replay of the {phase} phase ("
                           f"{r['device_events']} device events)",
                           r["kernels"], phase_launches(phase, impl))
        whole = ph["whole"]
        want = profiled_launches("step", impl)
        check_launches(f"{impl}: one replay of the whole graph",
                       {k: whole["kernels"][k] for k in want}, want)
        kernels.setdefault(impl, {p: r["kernels"]
                                  for p, r in ph["phases"].items()})
        line = "; ".join(
            f"{p} compile {r['compile_s']:.3f} s (warm-up {r['warmup_s']:.3f}, "
            f"capture {r['capture_s']:.3f}), first replay "
            f"{r['first_replay_s']:.4f} s, replays best {r['best_s']:.4f} "
            f"median {r['median_s']:.4f} s, events best "
            f"{r['event_best_s']:.4f} median {r['event_median_s']:.4f} s, "
            f"{r['device_events']} device events"
            for p, r in ph["phases"].items())
        print(f"phases {impl} step B={STEP_BATCH} (one CUDA graph a phase, "
              f"best and median of {profile_verify.REPS}): {line}; "
              f"plonk_only {ph['plonk_only_s']:.4f} s (events "
              f"{ph['plonk_only_event_s']:.4f}), fri_only "
              f"{ph['fri_only_s']:.4f} s (events {ph['fri_only_event_s']:.4f}"
              f"), plonk + fri - transcript "
              f"{ph['plonk_plus_fri_less_transcript_s']:.4f} s; the whole "
              f"graph best {whole['best_s']:.4f} median "
              f"{whole['median_s']:.4f} s, events best "
              f"{whole['event_best_s']:.4f} median "
              f"{whole['event_median_s']:.4f} s (captured here: "
              f"{whole['captured_here']}); peak device memory "
              f"{ph['peak_allocated_mib']:.1f} MiB allocated, "
              f"{ph['peak_reserved_mib']:.1f} MiB reserved; plonk_ok and "
              f"fri_ok equal the compiled verifier's on all {STEP_BATCH} "
              f"lanes [{card}]")
        stages = ", ".join(f"{k} {v:.5f}" for k, v in rp["stages"].items())
        print(f"replayed {impl} step B={STEP_BATCH} (verify_batch after the "
              f"key's first call, medians of {profile_verify.REPS}, s): "
              f"{stages}; sum {rp['stage_sum_s']:.4f} s against "
              f"verify_batch without the timer "
              f"{[round(w, 4) for w in rp['unprobed_s']]} (median "
              f"{rp['unprobed_median_s']:.4f} s) [{card}]")
        print(f"probe {impl} JSON: " + json.dumps(
            {"phases": ph, "replayed": rp}))
    return kernels


def profiled_launches(fixture, impl):
    """The kernel launches torch.profiler sees in one verification: those
    of ``per_verify``, with the sponge under the transcript kernel's name."""
    want = per_verify(fixture, impl)
    want["poseidon_gl_transcript"] += want.pop("poseidon_gl_pi_hash")
    return want


def timed_path(fn, keep_graphs=False):
    """(fn(), wall s, the kernel launches of fn alone), the compiled cache
    emptied first unless ``keep_graphs``, so that fn's keys capture their
    graphs within it."""
    if not keep_graphs:
        verifier.compiled_verifier.cache_clear()
    torch.cuda.synchronize()
    kernel_launches.reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, kernel_launches.read()


def check_launches(what, launches, want):
    """Fail unless ``what`` launched each kernel as ``want`` says."""
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")


def parallel_paths(dev, card, spec_step, batch_step, expected):
    """The mesh and distributed paths on the step batch (and the (1, 2)
    mesh on the query-shard decode_block lanes), each through the compiled
    verifier, its cache emptied first; returns each path's launches (a
    key's warm-up and capture, each verifying every proof shard and query
    shard once)."""
    n_gpu = torch.cuda.device_count()
    step1 = per_verify("step", "mxu")
    db1 = per_verify("decode_block", "mxu")
    launches = {}

    def same(got, what, want=expected):
        if not np.array_equal(got, want):
            raise AssertionError(f"{what}: step verdicts differ from "
                                 f"verify_batch in lanes "
                                 f"{np.nonzero(got != want)[0].tolist()}")

    def second(fn):
        # the same keys again: replays only, no launch through a wrapper
        out, wall, counts = timed_path(fn, keep_graphs=True)
        if any(counts.values()):
            raise AssertionError(f"a second call launched through the "
                                 f"wrappers: {counts}")
        return out, wall

    mesh = pmesh.make_mesh()
    run = lambda: pmesh.verify_batch_sharded(spec_step, batch_step, mesh)
    got, first, launches["mesh_1d"] = timed_path(run)
    again, wall = second(run)
    same(got, "1-D mesh")
    same(again, "1-D mesh, second call")
    check_launches("1-D mesh", launches["mesh_1d"],
                   times(CAPTURE_RUNS * n_gpu, step1))
    print(f"1-D mesh over {n_gpu} GPU(s): step B={STEP_BATCH}, lane "
          f"{CORRUPT_LANE} alone rejected; wall per batch {first:.3f} s "
          f"first call (capture), {wall:.3f} s second call; launches "
          f"{launches['mesh_1d']} [{card}]")

    # two proof shards of one key on one card share a graph; the corrupted
    # lane lies in the second
    mesh21 = pmesh.make_mesh_2d([dev, dev], (2, 1))
    batch_r = {k: v.copy() for k, v in batch_step.items()}
    for k in batch_r:
        batch_r[k][[CORRUPT_LANE, RANKS_CORRUPT_LANE]] = \
            batch_step[k][[RANKS_CORRUPT_LANE, CORRUPT_LANE]]
    want_r = np.ones(STEP_BATCH, bool)
    want_r[RANKS_CORRUPT_LANE] = False
    run = lambda: pmesh.verify_batch_sharded_2d(spec_step, batch_r, mesh21)
    got, first, launches["mesh_2x1"] = timed_path(run)
    again, wall = second(run)
    same(got, "(2, 1) mesh", want_r)
    same(again, "(2, 1) mesh, second call", want_r)
    check_launches("(2, 1) mesh", launches["mesh_2x1"],
                   times(CAPTURE_RUNS, step1))
    print(f"(2, 1) proof mesh on [{dev}, {dev}] (two shards of B="
          f"{STEP_BATCH // 2}, one graph): lane {RANKS_CORRUPT_LANE} alone "
          f"rejected; wall per batch {first:.3f} s first call, {wall:.3f} s "
          f"second call; launches {launches['mesh_2x1']} [{card}]")
    back_to_back(dev, f"(2, 1) mesh on [{dev}, {dev}] (corrupted lane in the "
                 f"second shard)", lambda: [torch.as_tensor(run())],
                 [want_r])

    mesh2 = pmesh.make_mesh_2d([dev, dev], (1, 2))
    run = lambda: pmesh.verify_batch_sharded_2d(spec_step, batch_step, mesh2)
    got, first, launches["mesh_2d"] = timed_path(run)
    again, wall = second(run)
    same(got, "(1, 2) mesh")
    same(again, "(1, 2) mesh, second call")
    check_launches("(1, 2) mesh", launches["mesh_2d"],
                   times(CAPTURE_RUNS * 2, step1))
    print(f"(1, 2) proof x query mesh on [{dev}, {dev}]: step B={STEP_BATCH}, "
          f"lane {CORRUPT_LANE} alone rejected; wall per batch {first:.3f} s "
          f"first call, {wall:.3f} s second call; launches "
          f"{launches['mesh_2d']} [{card}]")
    spec_q, raws, vraw = query_shard_lanes(TESTDATA / "decode_block")
    batch_q, _, errors = serde.ingest_batch(spec_q, [(r, vraw) for r in raws])
    if list(errors) != [3]:
        raise AssertionError(f"query-shard lanes: ingest errors {errors}")
    out, wall, launches["mesh_2d_decode_block"] = timed_path(
        lambda: pmesh.verify_batch_sharded_2d(spec_q, batch_q, mesh2,
                                              diagnostics=True))
    shards = out["query_shards"].tolist()
    if (out["verdict"].tolist() != DECODE_EXPECTED
            or shards[2] != [True, False] or shards[3] != [True, True]):
        raise AssertionError(f"(1, 2) mesh: decode_block {out}")
    check_launches("(1, 2) mesh, decode_block",
                   launches["mesh_2d_decode_block"],
                   times(CAPTURE_RUNS * 2, db1))
    print(f"(1, 2) mesh: decode_block [valid, bad opening, last-round leaf, "
          f"quarantined]: {out['verdict'].tolist()}, per query shard "
          f"{shards}; wall {wall:.3f} s (capture) [{card}]")

    distributed.initialize("nccl", f"tcp://localhost:{dist_worker.free_port()}",
                           1, 0, dev)
    try:
        # the first call's first collective also sets up NCCL's communicator
        (got, n_accept), wall, launches["distributed_1"] = timed_path(
            lambda: distributed.verify_batch_distributed(spec_step,
                                                         batch_step, dev))
        (again, _), wall2 = second(
            lambda: distributed.verify_batch_distributed(spec_step,
                                                         batch_step, dev))
    finally:
        torch.distributed.destroy_process_group()
    same(got, "distributed, world size 1")
    same(again, "distributed, world size 1, second call")
    if n_accept != STEP_BATCH - 1:
        raise AssertionError(f"distributed, world size 1: n_accept {n_accept}")
    check_launches("distributed, world size 1", launches["distributed_1"],
                   times(CAPTURE_RUNS, step1))
    print(f"verify_batch_distributed, world size 1 (nccl): step B="
          f"{STEP_BATCH}, n_accept {n_accept}; wall per batch {wall:.3f} s "
          f"first call (capture), {wall2:.3f} s second call [{card}]")

    argv = ["--circuit", str(TESTDATA / "step"),
            "--local-batch", str(STEP_BATCH // 2),
            "--corrupt", str(RANKS_CORRUPT_LANE), "--iters", "2"]
    if n_gpu < 2:  # NCCL refuses two ranks on one GPU
        argv += ["--backend", "gloo", "--device", str(dev)]
    t0 = time.perf_counter()
    ranks = dist_worker.launch(2, argv, timeout=600)
    job_s = time.perf_counter() - t0
    want = np.ones(STEP_BATCH, bool)
    want[RANKS_CORRUPT_LANE] = False
    for r in ranks:
        if r["verdicts"] != want.tolist() or r["n_accept"] != STEP_BATCH - 1:
            raise AssertionError(f"two ranks: rank {r['rank']} verdicts "
                                 f"wrong or n_accept {r['n_accept']}")
        check_launches(f"two ranks: rank {r['rank']}", r["launches"],
                       times(CAPTURE_RUNS, step1))
    launches["distributed_2_ranks"] = {
        k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    print(f"verify_batch_distributed, two ranks as subprocesses "
          f"({ranks[0]['backend']}; {', '.join(r['device'] for r in ranks)}): "
          f"B={STEP_BATCH // 2} each, lane {RANKS_CORRUPT_LANE} alone "
          f"rejected on both, n_accept {STEP_BATCH - 1}; wall per batch (first "
          f"call with capture, second call) rank 0 {ranks[0]['seconds']}, "
          f"rank 1 {ranks[1]['seconds']} s; job {job_s:.1f} s with start-up "
          f"[{card}]")
    return launches


def tool_runs(dev, card):
    """One short run of tools/micro_pb and of tools/scaling_bench; returns
    (their launches, micro_pb's report)."""
    launches = {}
    kernel_launches.reset()
    report = micro_pb.run(dev)
    launches["micro_pb"] = kernel_launches.read()
    if not (launches["micro_pb"]["poseidon_bn254"]
            and launches["micro_pb"]["poseidon_bn254_cios"]):
        raise AssertionError(f"micro_pb: launches {launches['micro_pb']}")
    for impl, r in report["impls"].items():
        print(f"micro_pb {impl}: chains of {report['steps']} launches at "
              f"{report['lanes']} lanes {r['chain_ms']} ms; "
              f"{r['ms_per_launch']:.4f} ms a launch, "
              f"{r['ns_per_permutation']:.4f} ns a permutation [{card}]")

    n_gpu = torch.cuda.device_count()
    buf = io.StringIO()
    verifier.compiled_verifier.cache_clear()  # its key captures here
    kernel_launches.reset()
    with contextlib.redirect_stdout(buf):
        rc = scaling_bench.main(["--sizes", f"1,{n_gpu + 1}", "--iters", "1"])
    launches["scaling_bench"] = kernel_launches.read()
    if rc != 0:
        raise AssertionError(f"scaling_bench: exit {rc}")
    first, above = json.loads(buf.getvalue().strip().splitlines()[-1])["mesh"]
    # whole verifications of step, each with every kernel of the path
    step1 = per_verify("step", "mxu")
    k = launches["scaling_bench"]["qe_inv"] // step1["qe_inv"]
    if (above.get("status") != "not measured" or k < 1
            or launches["scaling_bench"] != times(k, step1)):
        raise AssertionError(f"scaling_bench: {above}, launches "
                             f"{launches['scaling_bench']}")
    print(f"scaling_bench: mesh size 1, step B={first['global_batch']}: "
          f"{first['proofs_per_s']:.2f} proofs/s ({first['best_s']:.3f} s); "
          f"mesh size {above['n']}: not measured ({above['reason']}) [{card}]")
    return launches, report


def run_cli(argv, card, fixture):
    """cli.main(argv) in this process, the compiled cache emptied first; its
    report line, tagged with the card; its launches: one key's warm-up and
    capture of a ``fixture`` batch.  Returns the launches."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, _, launches = timed_path(lambda: cli.main(argv))
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)}: exit {rc}\n{buf.getvalue()}")
    check_launches(f"cli {argv[0]}", launches,
                   times(CAPTURE_RUNS, per_verify(fixture, "mxu")))
    report = buf.getvalue().strip().splitlines()[-1]
    print(f"cli {argv[0]}: {report}; launches {launches} [{card}]")
    return launches


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
    for line in ptxas_report():
        print(f"ptxas: {line}")

    # -- 2. kernels vs plain versions at the main path's shapes and the
    #       shapes their tiling makes risky
    rng = np.random.default_rng(2024)
    spec_step, raw_step, vraw_step = load_fixture(TESTDATA / "step")
    spec_db_only = load_fixture(TESTDATA / "decode_block")[0]
    Q = spec_step.num_query_rounds
    lanes = [STEP_BATCH * Q, STEP_BATCH * Q * 4]  # leaf scans, Merkle paths
    # the same on half the batch or half the query rounds: two ranks of
    # B=128, or two query shards of a (1, 2) mesh
    par_lanes = [n // 2 for n in lanes]
    bn_lanes = sorted(set(lanes + par_lanes + BN_LANES_RISKY))
    bn_err, bn_ms, bn_plain = check_bn254_kernels(dev, rng, bn_lanes,
                                                  lanes + par_lanes)
    for n in lanes + par_lanes:
        t = bn_ms[n]
        print(f"poseidon_bn254 kernels A and CIOS at {n} lanes in turns A, "
              f"CIOS, CIOS, A: {t['a'][0]:.4f}, {t['cios'][0]:.4f}, "
              f"{t['cios'][1]:.4f}, {t['a'][1]:.4f} ms; plain "
              f"{bn_plain[n]['a']:.2f} and {bn_plain[n]['cios']:.2f} ms "
              f"[{card}]")
    print(f"poseidon_bn254 kernels A and CIOS: bit-exact at {bn_lanes} lanes "
          f"and a strided input")
    tr_err, tr_ms, tr_plain_ms, n_perms, tr_bytes = check_transcript_kernel(
        dev, rng, [spec_step, spec_db_only])
    print(f"transcript: bit-exact at B={TRANSCRIPT_BATCHES} on the step and "
          f"decode_block schedules; step schedule ({n_perms} permutations) "
          f"at B={STEP_BATCH}: kernel {tr_ms:.4f} ms; plain "
          f"{tr_plain_ms:.2f} ms at B={max(TRANSCRIPT_BATCHES)}, one call "
          f"[{card}]")
    latency_s = gl_mul_latency(dev)
    print(f"one dependent Goldilocks product: {latency_s * 1e9:.3f} ns "
          f"({latency_s * rate / (SMS * IMAD_PER_SM_CLOCK):.1f} cycles at "
          f"clocks.max.sm) [{card}]")
    chain_err = check_chain_kernels(dev, rng)
    print(f"QE Horner, powers and inverse and the public-input sponge: "
          f"bit-exact at {len(HORNER_CASES)}, {len(POWERS_CASES)} and "
          f"{len(INV_CASES)} shapes (the inverse at every K of {PER_THREAD}, "
          f"0 at warp edges and a whole warp), strided input, and n = "
          f"{PI_HASH_N} at B = 1 and {STEP_BATCH}")
    chain_t = time_chain_kernels(dev, rng, rate, latency_s)
    prod_err = check_product_kernels(
        dev, rng, {"step": spec_step, "decode_block": spec_db_only})
    print(f"Goldilocks and QE products: bit-exact at {PRODUCT_SHAPES}, on "
          f"the call sites' broadcast patterns, strided views and an empty "
          f"lead shape, c = {MUL_CONSTS}; the bit-selected product by a "
          f"constant at both fixtures' subgroup_x and cosetStart calls, "
          f"{BITS_LANES} lanes, 64-bit indices, bits 48 to 63, all 64, odd "
          f"tables, c = 0, strided and broadcast operands; the "
          f"interpolation scan on both fixtures' gates at {SCAN_LANES} lanes "
          f"against the plain scan on CPU copies")
    chain_t.update(time_product_kernels(dev, rng, rate, latency_s, spec_step))
    for name, t in chain_t.items():
        print(f"{name} at {t['shape']}: kernel {t['ms']:.5f} ms, plain "
              f"{t['plain_ms']:.4f} ms in a graph and {t['plain_eager_ms']:.2f}"
              f" ms eagerly; bound {t['bound_ms']:.5f} ms ({t['bound_by']}"
              + (f", {t['bound_form']}" if "bound_form" in t else "") + ")"
              + (f", the scan's chain {t['scan_latency_ms']:.5f} ms"
                 if "scan_latency_ms" in t else "")
              + (f", the prefix-suffix form's chain "
                 f"{t['prefix_suffix_latency_ms']:.5f} ms"
                 if "prefix_suffix_latency_ms" in t else "") + f" [{card}]")
    for name in ("qe_horner", "qe_powers"):
        for r in chain_t[name]["at_main_path_shapes"]:
            widths = ", ".join(f"{g}: {ms:.5f}"
                               for g, ms in r["group_ms"].items())
            print(f"{name} at {r['shape']} ({r['lanes']} lanes x {r['n']}, "
                  f"{r['calls']} a verification): G = {r['group']}, kernel "
                  f"{r['ms']:.5f} ms, bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']}); chain {r['n']} deep, n x L "
                  f"{r['scan_latency_ms']:.5f} ms, split {r['chain_depth']} "
                  f"deep, {r['split_latency_ms']:.5f} ms; ms at each G "
                  f"{{{widths}}} [{card}]")
        print(f"{name}: one verification's calls "
              f"{chain_t[name]['ms_one_verification']:.5f} ms, bound "
              f"{chain_t[name]['bound_ms_one_verification']:.5f} ms [{card}]")
    for r in chain_t["qe_inv"]["at_main_path_shapes"]:
        per_k = ", ".join(f"{k}: {ms:.5f}"
                          for k, ms in r["per_thread_ms"].items())
        print(f"qe_inv at {r['shape']} ({r['calls']} a verification): K = "
              f"{r['per_thread']}, kernel {r['ms']:.5f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}; one inversion an "
              f"element: {r['bound_one_inversion_an_element_ms']:.5f}); a "
              f"warp {r['batch_depth']} products deep, "
              f"{r['batch_latency_ms']:.5f} ms; ms at each K {{{per_k}}} "
              f"[{card}]")
    print(f"qe_inv: one verification's calls "
          f"{chain_t['qe_inv']['ms_one_verification']:.5f} ms, bound "
          f"{chain_t['qe_inv']['bound_ms_one_verification']:.5f} ms [{card}]")
    for r in chain_t["gl_mul_const"]["bits_form"]:
        print(f"gl_mul_const, bit-selected, {r['call']} at {r['shape']}: "
              f"kernel {r['ms']:.5f} ms (one launch) against the loop it "
              f"replaces {r['loop_ms']:.5f} ms ({r['loop_launches']}); "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}) [{card}]")

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

    # -- 2b. FRI's chain kernels on the main path's inputs, in turns
    chains = merkle_chain_phase(dev, card, rate, latency_s, {
        f"step B={STEP_BATCH}": (spec_step, batch_step),
        "decode_block B=4": (spec_db, batch_db)})

    torch.cuda.reset_peak_memory_stats(dev)
    got_db, launches, launches_step, step_s = main_path("mxu", *args)
    entry = verifier.compiled_verifier(spec_step, STEP_BATCH, dev, "mxu")
    print(f"mxu: step B={STEP_BATCH}: lane {CORRUPT_LANE} rejected, "
          f"{STEP_BATCH - 1} accepted; first call {step_s:.3f} s, of it the "
          f"eager warm-up {entry.warmup_s:.3f} s and the capture with "
          f"instantiation {entry.capture_s:.3f} s [{card}]")
    print(f"mxu: decode_block [valid, bad opening, bad leaf, bad pow]: "
          f"{got_db['verdict'].tolist()}, plonk_ok "
          f"{got_db['plonk_ok'].tolist()}, fri_ok {got_db['fri_ok'].tolist()}")
    print(f"mxu: launches on the main path (the Python counters: each key's "
          f"eager warm-up and capture, no replay): {launches}; of them the "
          f"step batch: {launches_step}")
    # -- 4. the compiled verifier: replay against eager, re-fed and
    #       malformed batches, launches inside a replay, walls
    replay_kernels, replay = {}, {}
    replay_kernels["mxu"], replay["mxu"] = compiled_checks(
        "mxu", dev, card, spec_step, batch_step, expected, spec_db, batch_db)

    got_db_c, launches_c, launches_c_step, step_c_s = main_path("cios", *args)
    for key in ("verdict", "plonk_ok", "fri_ok"):
        if not np.array_equal(got_db_c[key], got_db[key]):
            raise AssertionError(f"cios: decode_block {key} differs from mxu")
    entry_c = verifier.compiled_verifier(spec_step, STEP_BATCH, dev, "cios")
    print(f"cios: step B={STEP_BATCH}: lane {CORRUPT_LANE} rejected, "
          f"{STEP_BATCH - 1} accepted, first call {step_c_s:.3f} s (warm-up "
          f"{entry_c.warmup_s:.3f} s, capture {entry_c.capture_s:.3f} s); "
          f"decode_block {got_db_c['verdict'].tolist()}, as under mxu [{card}]")
    print(f"cios: launches on the path: {launches_c}; of them the step "
          f"batch: {launches_c_step}")

    replay_kernels["cios"], replay["cios"] = compiled_checks(
        "cios", dev, card, spec_step, batch_step, expected, spec_db, batch_db)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"peak device memory with the graphs held (step B={STEP_BATCH} and "
          f"decode_block B=4, eager runs beside them): "
          f"{peak / 2**20:.1f} MiB allocated, "
          f"{torch.cuda.max_memory_reserved(dev) / 2**20:.1f} MiB reserved "
          f"(the graphs' pools) [{card}]")

    # -- 5. stage times (tools/profile_verify, eager), in turns
    for impl in ("mxu", "cios", "cios", "mxu"):
        with pb.use_impl(impl):
            st = profile_verify.profile_stages(spec_step, batch_step, dev)
        if not np.array_equal(st.pop("verdicts"), expected):
            raise AssertionError(f"{impl}: stage probe gave other verdicts")
        print(f"stages {impl} step B={STEP_BATCH} (s, eager): "
              f"{json.dumps(st)} [{card}]")

    # -- 5a. the compiled phases and the host stages of a replayed batch
    #        (tools/profile_verify), in turns
    probe_s = time.perf_counter()
    phase_kernels = phase_probe(dev, card, spec_step, batch_step, expected)
    print(f"the probe on the compiled path, 4 turns: "
          f"{time.perf_counter() - probe_s:.1f} s [{card}]")

    # -- 5b. one eager step batch under the profiler under each setting
    for impl in ("mxu", "cios"):
        wall, n_dev, busy, per_kernel = profile_batch(
            impl, lambda: eager(spec_step, batch_step, dev))
        for key in [CHAIN_FORMS[impl][1]]:
            if busy <= 0 or per_kernel[key][0] == 0:
                raise AssertionError(f"{impl}: the profile shows no {key} "
                                     f"launch")
        want = profiled_launches("step", impl)
        got = {k: per_kernel[k][0] for k in want}
        if got != want:
            raise AssertionError(f"{impl}: the eager profile shows {got}, "
                                 f"expected {want}")
        kern = ", ".join(f"{k} {n} launches {t:.6f} s"
                         for k, (n, t) in per_kernel.items() if n)
        print(f"profile {impl} step B={STEP_BATCH}, eager: wall {wall:.4f} s "
              f"under the profiler, {n_dev} device events, device busy "
              f"{busy:.4f} s ({busy / wall:.4f} of the wall); {kern} [{card}]")

    # -- 6. soundness matrix on step, its key captured here
    for impl in ("mxu", "cios"):
        with pb.use_impl(impl):
            sm, _, sm_launches = timed_path(
                lambda: soundness_matrix.run("step", dev))
        if not sm["all_correct"]:
            raise AssertionError(f"{impl}: soundness matrix {sm['rows']}")
        check_launches(f"soundness matrix {impl}", sm_launches,
                       times(CAPTURE_RUNS, per_verify("step", impl)))
        print(f"soundness matrix {impl}: step, {sm['lanes']} lanes, "
              f"all_correct {sm['all_correct']}; launches {sm_launches}")

    # -- 7. the command line
    run_cli(["verify", "--circuit", str(TESTDATA / "decode_block"),
             "--batch", "4"], card, "decode_block")
    run_cli(["bench", "--circuit", str(TESTDATA / "step"),
             "--batch", str(STEP_BATCH), "--iters", "3"], card, "step")

    # -- 8. the parallel paths and their tools
    par_launches = parallel_paths(dev, card, spec_step, batch_step, expected)
    tool_launches, _ = tool_runs(dev, card)
    par_launches.update(tool_launches)

    bn_bound, bn_by, bn_form = bn254_bound(lanes[-1], rate)
    bn_bound_small = bn254_bound(lanes[0], rate)[0]
    bn_latency = bn254_latency_ms(latency_s)

    def at_lanes(n, key):
        return {"lanes": n, "ms": float(np.mean(bn_ms[n][key])),
                "plain_ms": bn_plain[n][key],
                "bound_ms": bn254_bound(n, rate)[0]}

    def at_small(key):
        # the per-level form's other launch size: the leaf scans' and FRI
        # layers' lane count
        return at_lanes(lanes[0], key)

    def on_parallel_paths(name):
        return {path: counts[name] for path, counts in par_launches.items()}

    tr_bound, tr_by, tr_form = transcript_bound(n_perms, STEP_BATCH, tr_bytes,
                                                rate, latency_s)
    kernels = [
        {"name": "poseidon_bn254", "route": "cuda",
         "source": "plonky2_tpu_torch/csrc/poseidon_bn254.cu",
         "replaces": "plonky2_tpu/kernels/poseidon_bn254_mxu.py:253",
         "launches": par_launches["micro_pb"]["poseidon_bn254"],
         "launches_path": SINGLE_PERMUTATION_PATH,
         "launches_on_main_path": launches["poseidon_bn254"],
         "max_abs_err": bn_err["a"],
         "lanes": lanes[-1], "ms": float(np.mean(bn_ms[lanes[-1]]["a"])),
         "plain_ms": bn_plain[lanes[-1]]["a"],
         "bound_ms": bn_bound, "bound_by": bn_by, "bound_form": bn_form,
         "latency_bound_ms": bn_latency,
         "library_ms": NO_LIBRARY,
         "launches_in_one_replay": replay_kernels["mxu"]["poseidon_bn254"][0],
         "at_smaller_launch": at_small("a"),
         "at_parallel_launches": [at_lanes(n, "a") for n in par_lanes],
         "launches_on_parallel_paths": on_parallel_paths("poseidon_bn254")},
        {"name": "poseidon_bn254_cios", "route": "cuda",
         "source": "plonky2_tpu_torch/csrc/poseidon_bn254_cios.cu",
         "replaces": "plonky2_tpu/kernels/poseidon_bn254_pallas.py:263",
         "launches": par_launches["micro_pb"]["poseidon_bn254_cios"],
         "launches_path": SINGLE_PERMUTATION_PATH,
         "launches_on_main_path": launches_c["poseidon_bn254_cios"],
         "max_abs_err": bn_err["cios"],
         "lanes": lanes[-1], "ms": float(np.mean(bn_ms[lanes[-1]]["cios"])),
         "plain_ms": bn_plain[lanes[-1]]["cios"],
         "bound_ms": bn_bound, "bound_by": bn_by, "bound_form": bn_form,
         "latency_bound_ms": bn_latency,
         "library_ms": NO_LIBRARY,
         "launches_in_one_replay":
             replay_kernels["cios"]["poseidon_bn254_cios"][0],
         "at_smaller_launch": at_small("cios"),
         "at_parallel_launches": [at_lanes(n, "cios") for n in par_lanes],
         "launches_on_parallel_paths": on_parallel_paths(
             "poseidon_bn254_cios")},
        {"name": "poseidon_gl_transcript", "route": "cuda",
         "source": "plonky2_tpu_torch/csrc/poseidon_gl_transcript.cu",
         "replaces": "plonky2_tpu/kernels/poseidon_gl_pallas.py:230",
         "launches": launches["poseidon_gl_transcript"], "max_abs_err": tr_err,
         "ms": tr_ms, "plain_ms": tr_plain_ms,
         "bound_ms": tr_bound, "bound_by": tr_by, "bound_form": tr_form,
         "library_ms": NO_LIBRARY,
         "transcript_kernel_launches_in_one_replay":
             replay_kernels["mxu"]["poseidon_gl_transcript"][0],
         "launches_on_parallel_paths": on_parallel_paths(
             "poseidon_gl_transcript")},
        {"name": "poseidon_gl_pi_hash", "route": "cuda",
         "source": "plonky2_tpu_torch/csrc/poseidon_gl_transcript.cu",
         "replaces": "plonky2_tpu/hash/poseidon_gl.py:221",
         "launches": launches["poseidon_gl_pi_hash"],
         "max_abs_err": chain_err["poseidon_gl_pi_hash"],
         **chain_t["poseidon_gl_pi_hash"], "library_ms": NO_LIBRARY,
         "transcript_kernel_launches_in_one_replay":
             replay_kernels["mxu"]["poseidon_gl_transcript"][0],
         "launches_on_parallel_paths": on_parallel_paths(
             "poseidon_gl_pi_hash")},
    ]
    step_chains = chains[f"step B={STEP_BATCH}"]
    for impl, permutation in (
            ("mxu", "plonky2_tpu/kernels/poseidon_bn254_mxu.py:253"),
            ("cios", "plonky2_tpu/kernels/poseidon_bn254_pallas.py:263")):
        key, name = CHAIN_FORMS[impl]
        main = launches if impl == "mxu" else launches_c
        kernels.append({
            "name": name, "route": "cuda",
            "source": "plonky2_tpu_torch/csrc/fri_merkle.cu",
            "replaces": "plonky2_tpu/fri/verify.py:101",
            "also_replaces": ["plonky2_tpu/fri/verify.py:68", permutation],
            "launches": main[name],
            "max_abs_err": max(r["max_abs_err"] for r in chains.values()),
            "chains": step_chains["chains"],
            "permutations": step_chains["permutations"],
            "ms": float(np.mean(step_chains["ms"][key])),
            "plain_ms": step_chains["plain_ms"],
            "bound_ms": step_chains["bound_ms"],
            "bound_by": step_chains["bound_by"],
            "bound_form": step_chains["bound_form"],
            "latency_bound_ms": step_chains["latency_bound_ms"],
            "library_ms": NO_LIBRARY,
            "per_level_form_ms": float(np.mean(
                step_chains["per_level_ms"][key])),
            "layout": step_chains["layout"][key],
            "at_decode_block": {
                k: (v[key] if k == "layout" else float(np.mean(v[key]))
                    if isinstance(v, dict) else v)
                for k, v in chains["decode_block B=4"].items()},
            "launches_in_one_replay": replay_kernels[impl][name][0],
            "device_s_in_one_replay": replay_kernels[impl][name][1],
            "launches_on_parallel_paths": on_parallel_paths(name)})
    for name, replaces in (
            ("qe_horner", "plonky2_tpu/fields/goldilocks_ext.py:226"),
            ("qe_powers", "plonky2_tpu/fields/goldilocks_ext.py:237"),
            ("qe_inv", "plonky2_tpu/fields/goldilocks.py:365")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "plonky2_tpu_torch/csrc/goldilocks_ext.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": chain_err[name], **chain_t[name],
            "library_ms": NO_LIBRARY,
            "launches_in_one_replay": replay_kernels["mxu"][name][0],
            "device_s_in_one_replay": replay_kernels["mxu"][name][1],
            "launches_on_parallel_paths": on_parallel_paths(name)})
    for name, replaces, source in (
            ("gl_mul", "plonky2_tpu/fields/goldilocks.py:293",
             "plonky2_tpu_torch/csrc/goldilocks_mul.cu"),
            ("gl_mul_const", "plonky2_tpu/fields/goldilocks.py:297",
             "plonky2_tpu_torch/csrc/goldilocks_mul.cu"),
            ("qe_mul", "plonky2_tpu/fields/goldilocks_ext.py:59",
             "plonky2_tpu_torch/csrc/goldilocks_mul.cu"),
            ("coset_interp_scan", "plonky2_tpu/gates/gates.py:293",
             "plonky2_tpu_torch/csrc/goldilocks_mul.cu")):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": prod_err[name], **chain_t[name],
            "library_ms": NO_LIBRARY,
            "launches_in_one_replay": replay_kernels["mxu"][name][0],
            "device_s_in_one_replay": replay_kernels["mxu"][name][1],
            "launches_on_parallel_paths": on_parallel_paths(name)})
    for k in kernels:
        impl = "cios" if "cios" in k["name"] else "mxu"
        name = k["name"] if k["name"] in kernel_launches.DEVICE_NAMES \
            else "poseidon_gl_transcript"
        k["launches_in_one_phase_replay"] = {
            p: n[name] for p, n in phase_kernels[impl].items()}
    print(f"step B={STEP_BATCH} replay, graph alone (median of "
          f"{REPLAYS}): mxu {replay['mxu']['graph_median_s']:.4f} s, cios "
          f"{replay['cios']['graph_median_s']:.4f} s; device events in one "
          f"profiled replay: mxu {replay['mxu']['device_events']}, cios "
          f"{replay['cios']['device_events']} (with a Poseidon-BN254 "
          f"launch an absorb step and level: "
          f"{PER_LEVEL_BN254_REPLAY_EVENTS}; with int64 inputs: "
          f"{WIDE_INPUTS_REPLAY_EVENTS}; with the scan's operands "
          f"gathered: {GATHERED_SCAN_REPLAY_EVENTS}; with FRI's bit loops: "
          f"{LOOP_PRODUCTS_REPLAY_EVENTS}; with the plain products: "
          f"{PLAIN_PRODUCTS_REPLAY_EVENTS}; with the plain chains too: "
          f"{PLAIN_CHAINS_REPLAY_EVENTS}) [{card}]")
    print(f"kernel bounds at the timed shapes: BN254 {lanes[-1]} lanes "
          f"{bn_bound:.4f} ms, {lanes[0]} lanes {bn_bound_small:.4f} ms "
          f"({bn_form}), and a launch's latency bound {bn_latency:.5f} ms "
          f"({BN254_PERM_DEPTH} dependent products x "
          f"{latency_s * 1e9:.3f} ns); transcript {n_perms} x "
          f"{STEP_BATCH} permutations {tr_bound:.4f} ms ({tr_form}: "
          f"{n_perms} x {GL_PERM_DEPTH} x {latency_s * 1e9:.3f} ns) [{card}]")
    print(f"torch.profiler traces taken again after an empty device trace: "
          f"{device_kernels.empty_traces} [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
