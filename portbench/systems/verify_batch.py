"""The system ``verify_batch``: ``plonky2_tpu_torch``'s batch verifier on one
card, handed batches ingested and stacked in set-up.

Everything this system takes from the port is here: its spec parser and
ingest (set-up), ``verifier.verify_batch`` (the timed path), and its stage
timer (``utils.profiling.StageTimer``, the spans of the traced run).
"""

from __future__ import annotations


class System:
    """``load`` ingests a plan's distinct proofs and stacks its batches
    (set-up); ``verify(i)`` runs ``verify_batch`` on batch i and returns
    its {"verdict", "plonk_ok", "fri_ok"} arrays on the host."""

    def __init__(self, circuit_dir, device="cuda"):
        from plonky2_tpu_torch import verifier
        from plonky2_tpu_torch.proof import serde
        from plonky2_tpu_torch.proof.spec import load_circuit_spec
        from plonky2_tpu_torch.utils.profiling import StageTimer

        self._verifier, self._serde, self._timer = verifier, serde, StageTimer
        self.device = verifier.resolve_device(device)
        self.spec = load_circuit_spec(circuit_dir / "common_circuit_data.json")
        self.batches = []

    def load(self, plan):
        proofs = [self._serde.ingest_proof(self.spec, raw, plan.vraw)
                  for raw in plan.proofs]
        self.batches = [self._serde.stack_proofs([proofs[k] for k in lanes])
                        for lanes in plan.batches]

    def verify(self, i):
        return self._verifier.verify_batch(self.spec, self.batches[i],
                                           device=self.device,
                                           diagnostics=True)

    def verify_staged(self, i):
        """``verify(i)`` through ``verify_batch``'s own steps, with a stage
        timer on the compiled verifier's load and replay: (outputs,
        {stage: s})."""
        timer = self._timer(self.device)
        batch = self.batches[i]
        out = self._verifier.verify_on_device(self.spec, batch, self.device,
                                              timer=timer)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        out["verdict"] = self._verifier.apply_valid_masks(out["verdict"],
                                                          batch)
        return out, dict(timer.timings)

    def release(self):
        """Free the compiled verifiers (graphs, pools, pinned buffers)."""
        import torch

        self.batches = []
        self._verifier.compiled_verifier.cache_clear()
        torch.cuda.empty_cache()
