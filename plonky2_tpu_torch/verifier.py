"""Top-level batched Plonky2 verifier on torch tensors.

Counterpart of ``plonky2_tpu/verifier.py``:

    range-check proof        -> at ingestion (proof/serde.py)
    public-inputs hash       -> Poseidon-GL sponge (hash/poseidon_gl.py)
    GetChallenges            -> statically scheduled transcript scan
                                (transcript/challenger.py; the CUDA kernel
                                csrc/poseidon_gl_transcript.cu on the GPU)
    PLONK vanishing check    -> plonk_checks/vanishing.py
    FRI                      -> fri/verify.py (Merkle hashing through the
                                CUDA kernel csrc/poseidon_bn254.cu, or
                                csrc/poseidon_bn254_cios.cu under
                                PLONKY2_TPU_PB_IMPL=cios, on the GPU)

``verify_batch(spec, proofs)`` verifies B same-shape proofs at once on the
GPU and returns one boolean verdict per proof; an invalid proof is data,
never an exception.  Only an explicit ``device="cpu"`` runs it on the CPU
(through the kernels' plain torch versions); without a GPU the default
raises.

On the GPU every entry point (``verify_batch``, the meshes, the distributed
path, ``cli bench``) goes through the compiled verifier: ``verify_device``
captured once per (spec, batch size, device, Poseidon-BN254 kernel, query
window) in a CUDA graph and replayed, the counterpart of the JAX package's
per-shape ``jax.jit`` programs.  Its inputs are the JAX package's narrow
layout (``proof/convert.to_narrow``: 32-bit words), packed into a pinned
host buffer and copied to the card in one transfer; the graph widens them
(``proof/convert.widen``) before it verifies.  ``verify_device`` itself
stays eager: the CPU runs it on the widened batch, and so does the stage
probe's ``stages`` mode; its ``phases`` mode captures parts of it in graphs
of their own (``capture``).
"""

from __future__ import annotations

import contextlib
import functools
import time

import numpy as np
import torch

from .fields import goldilocks as gl
from .hash import poseidon_bn254 as pb
from .hash import poseidon_gl as pgl
from .transcript import challenger as chal
from .plonk_checks.vanishing import verify_plonk
from .fri.verify import check_query_rounds, query_rounds, verify_fri
from .proof import convert, serde
from .proof.serde import VALID_MASK, stack_proofs


def _stage(timer, name):
    """``timer.stage(name)`` (a ``utils.profiling.StageTimer``), or nothing
    when ``timer`` is None: no stage, no synchronisation."""
    return timer.stage(name) if timer else contextlib.nullcontext()


def _device_stage(timer, name, device):
    """``timer.device_stage(name, device)`` where the timer takes CUDA event
    pairs (a ``utils.profiling.SpanTimer``), else nothing."""
    device_stage = getattr(timer, "device_stage", None)
    return device_stage(name, device) if device_stage else \
        contextlib.nullcontext()


def resolve_device(device):
    """The torch device to run on, a CUDA device with its index (the
    current one for ``"cuda"``); a CUDA device must exist, never a silent
    fall-back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the verifier runs on the GPU "
                           "unless asked for the CPU (device=\"cpu\")")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_name(device):
    """The card's name (``torch.cuda.get_device_name``), or ``cpu``."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def proof_to_device(proof, device):
    """Batched numpy serde dict -> tensor dict on ``device``."""
    return convert.from_reference(proof, device)


def _extract_challenges(schedule, states):
    def one(pos):
        return chal.read_challenge(states, pos)

    qi = [one(p) for p in schedule.fri_query_indices]
    return {
        "plonk_betas": [one(p) for p in schedule.plonk_betas],
        "plonk_gammas": [one(p) for p in schedule.plonk_gammas],
        "plonk_alphas": [one(p) for p in schedule.plonk_alphas],
        "zeta": chal.read_qe(states, schedule.plonk_zeta),
        "fri_alpha": chal.read_qe(states, schedule.fri_alpha),
        "fri_betas": [chal.read_qe(states, p) for p in schedule.fri_betas],
        "pow_response": one(schedule.fri_pow_response),
        "query_indices": gl.stack(qi, axis=-1),
    }


def verify_device(spec, schedule, dev, obs, diagnostics=False, timer=None,
                  query_shard=None):
    """Verify a tensor batch: dev from ``proof_to_device``, obs the observed
    sequence as a GL pair (B, n_obs) on the same device.  With a
    ``utils.profiling.StageTimer`` each stage is timed on its own.

    ``query_shard=(k, n)``: dev's per-query-round arrays hold only the k-th
    of n contiguous blocks of the FRI query rounds (``fri.verify
    .query_rounds``), and FRI checks only those; the public-input hash, the
    transcript and the PLONK check run whole, as on a JAX 2-D mesh."""
    stage = functools.partial(_stage, timer)
    B = obs[0].shape[0]
    with stage("pi_hash"):
        pi_hash = pgl.hash_no_pad(dev["public_inputs"])
    with stage("transcript"):
        states = chal.run_transcript(schedule, obs, pi_hash)
    with stage("challenges"):
        challenges = _extract_challenges(schedule, states)
    ones = torch.ones((B,), dtype=torch.bool, device=obs[0].device)
    with stage("plonk"):
        plonk_ok = verify_plonk(spec, dev, challenges, pi_hash, ones)
    with stage("fri"):
        fri_ok = verify_fri(spec, dev, challenges, ones, query_shard)
    verdict = plonk_ok & fri_ok
    if diagnostics:
        return {"verdict": verdict, "plonk_ok": plonk_ok, "fri_ok": fri_ok}
    return verdict


@functools.lru_cache(maxsize=8)
def schedule_for(spec):
    return chal.build_schedule(spec)


def prepare(spec, proof_batch, device, timer=None, narrow=False):
    """Host side of a batch: (schedule, tensor dict, observed sequence),
    widened for ``verify_device`` (``proof/convert.widen``) or, with
    ``narrow``, the int32 words of the narrow layout that the compiled
    verifier takes (``proof/convert.to_narrow``).  With a ``utils
    .profiling.StageTimer``, the observed sequence (``observed``) and the
    tensors (``convert``) are timed apart."""
    schedule = schedule_for(spec)
    place = convert.to_tensors if narrow else convert.widen
    with _stage(timer, "observed"):
        obs = place(convert.split_words(
            chal.build_observed_host(spec, proof_batch)), device)
    with _stage(timer, "convert"):
        dev = place(convert.to_narrow(proof_batch), device)
    return schedule, dev, obs


def apply_valid_masks(verdict, proof_batch, valid_mask=None):
    """(B,) bool numpy verdicts with every quarantined lane False: the mask
    that ``serde.ingest_batch`` stores in the batch and, when given, the
    caller's ``valid_mask`` ((B,) bool)."""
    for mask in (proof_batch.get(VALID_MASK), valid_mask):
        if mask is not None:
            verdict = verdict & np.asarray(mask, dtype=bool)
    return verdict


def check_batch(spec, proof_batch, batch_size, query_shard=None):
    """Raise ValueError unless the numpy serde dict ``proof_batch`` has
    exactly the keys, shapes and dtypes of ``batch_size`` proofs of ``spec``
    holding the query rounds of ``query_shard``: its query rounds first,
    then every array, the ``*_tovec`` chunks and the mask too
    (``serde.batch_error``), then the batch size."""
    check_query_rounds(spec, proof_batch, query_shard)
    start, stop = query_rounds(spec, query_shard)
    error = serde.batch_error(spec, proof_batch, stop - start)
    if error is None and len(proof_batch["pow_witness"]) != batch_size:
        error = (f"batch size {len(proof_batch['pow_witness'])}, not "
                 f"{batch_size}")
    if error is not None:
        raise ValueError(f"batch not in the layout of its key: {error}")


# ---------------------------------------------------------------------------
# The compiled verifier: one CUDA graph per key
# ---------------------------------------------------------------------------

def _leaves(tree, name=""):
    """(name, tensor) pairs of a nest of dicts and tuples, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [(name, tree)]
    items = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
    return [leaf for k, x in items
            for leaf in _leaves(x, f"{name}.{k}" if name else str(k))]


def check_inputs(static, given):
    """Raise ValueError unless the nest ``given`` has the structure of
    ``static`` and every tensor exactly its shape and dtype.  ``copy_``
    would broadcast (a batch of one query round would fill a buffer of 28
    silently) or convert, so nothing is copied into a graph's inputs
    unchecked."""
    want, got = _leaves(static), _leaves(given)
    if [n for n, _ in want] != [n for n, _ in got]:
        raise ValueError(f"inputs {[n for n, _ in got]} differ from the "
                         f"compiled verifier's {[n for n, _ in want]}")
    for (name, w), (_, g) in zip(want, got):
        if (g.shape, g.dtype) != (w.shape, w.dtype):
            raise ValueError(f"input {name} is {g.dtype} {tuple(g.shape)}; "
                             f"the compiled verifier of this key takes "
                             f"{w.dtype} {tuple(w.shape)}")


def capture(fn, device):
    """Capture ``fn()``, a function of tensors that stay where they are (a
    graph's static inputs), in a CUDA graph on ``device``: one eager run on
    a side stream first, which fills the constant tables (``goldilocks
    .device_table``), the kernels' tables and their one-time attributes,
    then the capture on that stream.  Returns (graph, outputs, warmup_s,
    capture_s): the outputs are the graph's own tensors, which each replay
    overwrites; ``capture_s`` holds the capture and instantiation.  A
    failed capture raises."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    t0 = time.perf_counter()
    with torch.cuda.stream(side):
        fn()
    side.synchronize()
    warmup_s = time.perf_counter() - t0
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, stream=side):
        outputs = fn()
    return graph, outputs, warmup_s, time.perf_counter() - t0


OBSERVED = "observed"  # the observed sequence's slot in a flat buffer


class CompiledVerifier:
    """``verify_device(..., diagnostics=True)`` of one key, captured in a
    CUDA graph on the narrow layout.

    The graph's static inputs are the narrow leaves of the key's layout
    (``serde.zero_batch`` and its observed sequence; ``proof/convert
    .to_narrow``), views of one flat int32 buffer on the card (``flat``,
    ``convert.flat_layout``); the captured function widens them
    (``convert.widen``, one ``bitwise_and`` a leaf) and verifies.  A batch
    comes in through ``load``: its arrays checked against the key's layout,
    their bytes packed into a pinned host buffer (``staging``, allocated at
    the first ``load`` and kept: at step B=256 some 51 MB of pinned host
    memory a key, 0.41 GB at the cache's 8 keys), and one host-to-device
    copy on the replay's stream.  FRI's Merkle-leaf absorb blocks are not
    in the layout: the graph builds them from the leaves
    (``fri/merkle.leaf_blocks``).  A CUDA event recorded after that copy is
    waited on before the next pack, so a batch loaded while the last one's
    copy is in flight cannot overwrite it.  ``__call__`` copies narrow
    tensors in instead (``prepare(..., narrow=True)``).  ``replay`` captures
    at the key's first call (``capture``: ``warmup_s``, ``capture_s``),
    replays the graph and returns clones of the outputs, so the next replay
    cannot overwrite a result not yet read.  A failed allocation, copy,
    capture or replay raises: nothing falls back to the eager path."""

    def __init__(self, spec, batch_size, device, mode, query_shard=None):
        start, stop = query_rounds(spec, query_shard)
        self.spec, self.device = spec, torch.device(device)
        self.mode, self.query_shard = mode, query_shard
        self.batch_size = batch_size
        self.schedule = schedule_for(spec)
        zeros = serde.zero_batch(spec, batch_size, stop - start)
        arrays = convert.device_arrays(zeros)
        arrays[OBSERVED] = chal.build_observed_host(spec, zeros)
        self.slots, words = convert.flat_layout(arrays)
        self.flat = torch.zeros(words, dtype=torch.int32, device=self.device)
        leaves = convert.narrow_views(self.slots, self.flat)
        obs = leaves.pop(OBSERVED)
        self.inputs = {"proof": leaves, "obs": obs}
        self.staging = self.copied = None
        self.graph = self.outputs = None
        self.warmup_s = self.capture_s = None

    @property
    def bytes_in(self):
        """Bytes copied to the card by a ``load``: the narrow layout's."""
        return self.flat.numel() * self.flat.element_size()

    def _verify(self):
        with pb.use_impl(self.mode):
            return verify_device(self.spec, self.schedule,
                                 convert.widen(self.inputs["proof"],
                                               self.device),
                                 convert.widen(self.inputs["obs"],
                                               self.device),
                                 diagnostics=True,
                                 query_shard=self.query_shard)

    def load(self, proof_batch, timer=None):
        """Load the numpy serde dict ``proof_batch`` for the next replay:
        ``check_batch`` before anything is copied and the observed sequence
        (stage ``observed``); the wait for the last load's copy and the
        pack into the pinned buffer (``convert``); one non-blocking copy to
        the card on the current stream and the event after it
        (``copy_in``)."""
        cuda = self.device.type == "cuda"
        with _stage(timer, "observed"):
            check_batch(self.spec, proof_batch, self.batch_size,
                        self.query_shard)
            arrays = convert.device_arrays(proof_batch)
            arrays[OBSERVED] = chal.build_observed_host(self.spec,
                                                        proof_batch)
        with _stage(timer, "convert"):
            if self.staging is None:
                self.staging = torch.empty(self.flat.shape, dtype=torch.int32,
                                           pin_memory=cuda)
            if self.copied is not None:
                self.copied.synchronize()
            convert.pack(self.slots, self.staging, arrays)
        with _stage(timer, "copy_in"):
            self.flat.copy_(self.staging, non_blocking=True)
            if cuda:
                self.copied = torch.cuda.Event()
                self.copied.record(torch.cuda.current_stream(self.device))

    def __call__(self, dev, obs, timer=None):
        """Verify the narrow tensors ``dev`` and ``obs`` (as ``prepare(...,
        narrow=True)`` makes them, on any device): {"verdict", "plonk_ok",
        "fri_ok"}, (B,) bool tensors on this entry's device, not yet
        synchronised.  With a ``utils.profiling.StageTimer``, the checks
        and copies in (``copy_in``) and ``replay``'s stages are timed
        apart."""
        given = {"proof": dev, "obs": obs}
        with torch.cuda.device(self.device):
            with _stage(timer, "copy_in"):
                check_query_rounds(self.spec, dev, self.query_shard)
                check_inputs(self.inputs, given)
                for (_, static), (_, x) in zip(_leaves(self.inputs),
                                               _leaves(given)):
                    static.copy_(x)
        return self.replay(timer)

    def replay(self, timer=None):
        """Replay the graph on what was loaded or copied in last (a key's
        first call captures first, untimed): {"verdict", "plonk_ok",
        "fri_ok"}, clones of the outputs, not yet synchronised.  With a
        ``utils.profiling.StageTimer``, the replay (``replay``) and the
        clones (``outputs``) are timed apart; a timer that takes device
        stages (``utils.profiling.SpanTimer``) also gets a pair of CUDA
        events around the graph's replay (``replay``)."""
        with torch.cuda.device(self.device):
            if self.graph is None:
                self.graph, self.outputs, self.warmup_s, self.capture_s = \
                    capture(self._verify, self.device)
            with _stage(timer, "replay"), \
                    _device_stage(timer, "replay", self.device):
                self.graph.replay()
            with _stage(timer, "outputs"):
                return {k: v.clone() for k, v in self.outputs.items()}


@functools.lru_cache(maxsize=8)
def _compiled(spec, batch_size, device, mode, query_shard):
    return CompiledVerifier(spec, batch_size, device, mode, query_shard)


def compiled_verifier(spec, batch_size, device, mode, query_shard=None):
    """The compiled verifier of one key, the counterpart of the JAX
    package's ``_compiled_verifier`` (an ``lru_cache(maxsize=8)`` of
    ``jax.jit``): at most 8 are held, and the least recently used one is
    dropped, with its graph and memory pool, when a ninth key comes.
    ``mode`` is the Poseidon-BN254 kernel (``poseidon_bn254.kernel_impl()``)
    the graph launches, the counterpart of the JAX ``_mode_key``.  The key
    is normalised (a CUDA device with its index, one query shard of one as
    none), so every spelling of a key finds one entry."""
    if query_shard == (0, 1):  # one shard holds every round
        query_shard = None
    return _compiled(spec, int(batch_size), resolve_device(device), mode,
                     query_shard)


compiled_verifier.cache_info = _compiled.cache_info
compiled_verifier.cache_clear = _compiled.cache_clear


def verify_on_device(spec, proof_batch, device, query_shard=None,
                     timer=None):
    """Verify a batched serde dict on ``device`` before any mask:
    {"verdict", "plonk_ok", "fri_ok"}, (B,) bool tensors on the device, not
    yet synchronised.  The CPU runs ``verify_device`` eagerly; a GPU runs
    the compiled verifier of (spec, B, device, the Poseidon-BN254 kernel,
    query window), capturing its graph at the key's first call.
    ``query_shard`` as in ``verify_device``.  On a GPU the batch reaches
    the graph in the narrow layout (``CompiledVerifier.load``): the host
    widens nothing.  With a ``utils.profiling.StageTimer``, the stages are
    timed apart: on a GPU ``CompiledVerifier.load``'s and ``replay``'s, on
    the CPU those of ``prepare`` and ``verify_device``."""
    device = resolve_device(device)
    if device.type == "cpu":
        schedule, dev, obs = prepare(spec, proof_batch, device, timer)
        return verify_device(spec, schedule, dev, obs, diagnostics=True,
                             timer=timer, query_shard=query_shard)
    entry = compiled_verifier(spec, np.shape(proof_batch["pow_witness"])[0],
                              device, pb.kernel_impl(), query_shard)
    entry.load(proof_batch, timer)
    return entry.replay(timer)


def verify_batch(spec, proof_batch, valid_mask=None, device="cuda",
                 diagnostics=False):
    """Verify a batched serde dict (leading axis B).  Returns (B,) bool.

    Runs on the GPU, through the compiled verifier, unless ``device="cpu"``.
    Lanes that failed validation at load time are always False: the mask
    that ``serde.ingest_batch`` stores in the batch is applied, and so is
    ``valid_mask`` when the caller passes one (optional (B,) bool).  With
    diagnostics, returns a dict of (B,) bool arrays: verdict, plonk_ok,
    fri_ok."""
    out = verify_on_device(spec, proof_batch, device)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["verdict"] = apply_valid_masks(out["verdict"], proof_batch, valid_mask)
    return out if diagnostics else out["verdict"]


def verify_one(spec, proof, device="cuda"):
    return bool(verify_batch(spec, stack_proofs([proof]), device=device)[0])
