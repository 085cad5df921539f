"""The system ``mesh4``: ``plonky2_tpu_torch``'s proof mesh over the four
cards of one host, driven from one process, handed batches ingested and
stacked in set-up.

Everything this system takes from the port is here: its spec parser and
ingest (set-up), ``parallel/mesh.verify_batch_sharded`` over ``cuda:0`` to
``cuda:3`` (the timed path: a contiguous quarter of the batch a card, each
card's shard loaded and replayed from the mesh's feed thread of that card),
and the port's ``utils.profiling.SpanTimer`` (the spans of the traced run).
"""

from __future__ import annotations

DEVICES = tuple(f"cuda:{i}" for i in range(4))


class System:
    """``load`` ingests a plan's distinct proofs and stacks its batches
    (set-up); ``verify(i)`` runs the mesh on batch i and returns its
    {"verdict", "plonk_ok", "fri_ok"} arrays on the host. ``devices``
    names the mesh's cards (a card may be named more than once)."""

    def __init__(self, circuit_dir, devices=DEVICES):
        from plonky2_tpu_torch import verifier
        from plonky2_tpu_torch.parallel import mesh
        from plonky2_tpu_torch.proof import serde
        from plonky2_tpu_torch.proof.spec import load_circuit_spec
        from plonky2_tpu_torch.utils.profiling import SpanTimer

        self._verifier, self._mesh = verifier, mesh
        self._serde, self._timer = serde, SpanTimer
        self.mesh = mesh.make_mesh(list(devices))
        self.spec = load_circuit_spec(circuit_dir / "common_circuit_data.json")
        self.batches = []

    def load(self, plan):
        proofs = [self._serde.ingest_proof(self.spec, raw, plan.vraw)
                  for raw in plan.proofs]
        self.batches = [self._serde.stack_proofs([proofs[k] for k in lanes])
                        for lanes in plan.batches]

    def verify(self, i):
        return self._mesh.verify_batch_sharded(self.spec, self.batches[i],
                                               self.mesh, diagnostics=True)

    def verify_staged(self, i):
        """``verify(i)`` with the mesh's spans and counts (a
        ``SpanTimer``, read once the outputs are on the host): (outputs,
        {span: s, count: n})."""
        timer = self._timer()
        out = self._mesh.verify_batch_sharded(self.spec, self.batches[i],
                                              self.mesh, diagnostics=True,
                                              timer=timer)
        return out, timer.read()

    def release(self):
        """Free the compiled verifiers (graphs, pools, pinned buffers) and
        every card's cached memory."""
        import torch

        self.batches = []
        self._verifier.compiled_verifier.cache_clear()
        for device in set(self.mesh.devices.flat):
            if device.type == "cuda":
                with torch.cuda.device(device):
                    torch.cuda.empty_cache()
