"""The plain reference put in the system's place, for the control and for
the tests that break the timed path.

The configuration states one guarantee: every lane's verdict, ``plonk_ok``
and ``fri_ok`` bit-exact, so that every invalid proof is rejected in its
own lane and every valid one accepted. It states no precision, so each
control breaks that guarantee in a way that would make a verifier faster:

- ``first_round``: FRI checks only the first of the query rounds (the
  soundness of one round in place of 28; a leaf or sibling corrupted in a
  later round passes);
- ``lane_blind``: the batch is judged as one (as a random-linear-combination
  batch check would), and every lane gets the batch's verdict.

The benchmark's own runs never use this module.
"""

from __future__ import annotations

from . import check

CONTROLS = ("first_round", "lane_blind")


class ReferenceSystem:
    """A stand-in with ``PortSystem``'s interface that answers each lane by
    the plain reference, or by a control (``CONTROLS``)."""

    def __init__(self, circuit_dir, control=None):
        if control not in (None, *CONTROLS):
            raise ValueError(f"unknown control {control!r}")
        self.circuit_dir, self.control = circuit_dir, control
        self.outputs = []

    def load(self, plan):
        rounds = 1 if self.control == "first_round" else None
        answers = check.reference_answers(self.circuit_dir, plan, rounds)
        want = check.expected(plan, answers)
        self.outputs = [{k: want[k][i].copy() for k in check.OUTPUTS}
                        for i in range(len(plan.batches))]
        if self.control == "lane_blind":
            for out in self.outputs:
                for k in check.OUTPUTS:
                    out[k][:] = out[k].all()

    def verify(self, i):
        return {k: v.copy() for k, v in self.outputs[i].items()}

    def verify_staged(self, i):
        return self.verify(i), {}

    def release(self):
        self.outputs = []


def no_chip_check(chips):
    """A ``chip_check`` that lets a run go on without a card."""


def run(workload, seed, seconds, control, catalog=None):
    """One run of ``workload`` with ``control`` (or, with None, the plain
    reference itself) in the system's place: the result dict."""
    from .main import parse, run_cell

    args = parse(["--workload", workload, "--seed", str(seed),
                  "--seconds", str(seconds), "--trace", "0"])
    result, _ = run_cell(args, 0.0, system_factory=lambda d: ReferenceSystem(
        d, control), catalog=catalog, chip_check=no_chip_check)
    return result


def wrong_lanes(result):
    """The control's reading: lanes wrong over the three outputs."""
    return {name: c["value"] for name, c in result["checks"].items()}


def summary(workload, seeds, seconds):
    """{control: {seed: its readings}} for each control on ``seeds``."""
    return {control: {seed: wrong_lanes(run(workload, seed, seconds,
                                            control))
                      for seed in seeds}
            for control in CONTROLS}
