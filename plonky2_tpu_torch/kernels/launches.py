"""The kernel wrappers' launch counters, by kernel name.

Each wrapper adds one to its ``.launches`` where it launches its kernel and
nowhere else, so a run that sets the counters to 0 before a path and reads
them after it shows which kernels the path went through.  A CUDA graph's
replay launches its kernels without calling a wrapper, so a replay counts
nothing here (``torch.profiler`` sees those launches).
"""

from __future__ import annotations

from . import fri_leaves as kl
from . import fri_merkle as kf
from . import goldilocks_ext as kq
from . import goldilocks_mul as km
from . import poseidon_bn254 as kb
from . import poseidon_bn254_cios as kc
from . import poseidon_gl_transcript as kt


def counters():
    """{kernel name: the wrapper that carries its ``.launches``}."""
    return {"poseidon_bn254": kb.permute,
            "poseidon_bn254_cios": kc.permute,
            "poseidon_gl_transcript": kt.run_transcript_kernel,
            "poseidon_gl_pi_hash": kt.hash_no_pad_kernel,
            "qe_horner": kq.horner,
            "qe_powers": kq.powers,
            "qe_inv": kq.inv,
            "gl_mul": km.gl_mul,
            "gl_mul_const": km.gl_mul_const,
            "qe_mul": km.qe_mul,
            "coset_interp_scan": km.coset_interp_scan,
            "merkle_chains_a": kf.chains_a,
            "merkle_chains_cios": kf.chains_cios,
            "fri_leaf_blocks": kl.leaf_blocks}


# The device kernel each counter's wrapper launches, as torch.profiler names
# it (a substring of the name).  The public-input sponge is a launch of the
# transcript kernel, so the profiler counts it under poseidon_gl_transcript.
DEVICE_NAMES = {"poseidon_bn254": "poseidon_bn254_kernel",
                "poseidon_bn254_cios": "poseidon_bn254_cios_kernel",
                "poseidon_gl_transcript": "transcript_kernel",
                "qe_horner": "qe_horner_kernel",
                "qe_powers": "qe_powers_kernel",
                "qe_inv": "qe_inv_kernel",
                "gl_mul": "gl_mul_kernel",
                "gl_mul_const": "gl_mul_const_kernel",
                "qe_mul": "qe_mul_kernel",
                "coset_interp_scan": "coset_interp_scan_kernel",
                "merkle_chains_a": "merkle_chains_a_kernel",
                "merkle_chains_cios": "merkle_chains_cios_kernel",
                "fri_leaf_blocks": "fri_leaf_blocks_kernel"}


def reset():
    for wrapper in counters().values():
        wrapper.launches = 0


def read():
    return {name: wrapper.launches for name, wrapper in counters().items()}
