"""Share of its roofline that FRI's Merkle chain kernel reaches, %: the
least time of the batch's Poseidon-BN254 permutations (counted from the
spec and B, harness/counts.py) over the device time a call spends in the
kernels whose names hold one of PATTERNS."""

from portbench.harness.readers import roofline_pct

PATTERNS = ("merkle_chains",)


def read(run):
    return roofline_pct(run, PATTERNS)
