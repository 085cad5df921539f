"""Build and load the hand-written CUDA kernels (``plonky2_tpu_torch/csrc``).

The sources have a plain C interface.  At first use ``nvcc`` compiles every
``csrc/*.cu`` for Hopper (``sm_90a``), one process per source, all started
together, and links the objects into one shared library,
``build/plonky2_tpu_torch/libp2t_kernels.so`` at the repository root, which
``ctypes`` loads.  The library is rebuilt whenever the hash of the sources
(headers included) and flags changes.  ``ptxas``'s report of each kernel's
registers, shared memory and spills is kept beside it (``ptxas_log``).
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "plonky2_tpu_torch"
LIB_NAME = "libp2t_kernels.so"
PTXAS_LOG = BUILD_DIR / "ptxas.log"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_DESC = ctypes.POINTER(ctypes.c_longlong)  # a host array of int64 words
_U64S = ctypes.POINTER(ctypes.c_uint64)  # a host array of u64 constants
_INTS = ctypes.POINTER(ctypes.c_int)  # a host array of ints
_SIGNATURES = {
    "p2t_poseidon_bn254_n_const": [],
    "p2t_poseidon_bn254_permute": [_P, _P, _P, _P, _I, _P],
    "p2t_poseidon_bn254_cios_n_const": [],
    "p2t_poseidon_bn254_cios_permute": [_P, _P, _P, _I, _P],
    "p2t_transcript_n_const": [],
    "p2t_transcript": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "p2t_gl_mul_chain": [_P, _U64, _I, _P],
    "p2t_qe_horner": [_DESC, _DESC] + [_P] * 4 + [_I, _I, _P],
    "p2t_qe_powers": [_DESC] + [_P] * 4 + [_I, _I, _P],
    "p2t_qe_inv": [_DESC] + [_P] * 4 + [_I, _P],
    "p2t_gl_mul": [_DESC, _P, _P],
    "p2t_gl_mul_const": [_DESC, _I, _U64, _U64S, _I, _I, _P, _P],
    "p2t_qe_mul": [_DESC, _I, _P, _P],
    "p2t_coset_interp_scan": [_DESC, _U64S, _U64S, _INTS, _I, _I, _I, _P,
                              _P],
    "p2t_merkle_chains_a": [_DESC, _P, _P, _P, _P],
    "p2t_merkle_chains_cios": [_DESC, _P, _P, _P],
    "p2t_merkle_chains_info": [_I, _I, _INTS],
}


class KernelError(RuntimeError):
    pass


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def nvcc_version():
    """The last line of ``nvcc --version`` (the release and build)."""
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def build(force=False):
    """Compile the kernels if the sources changed; returns (path, seconds
    spent compiling, 0.0 when the cached library was current)."""
    sources = _sources()
    digest = _digest(sources)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if (not force and lib.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f".{s.stem}.{tag}.o" for s in sources]
    tmp = BUILD_DIR / f".{LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for s, o in zip(sources, objs)]
    reports = []
    try:
        for s, proc in zip(sources, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise KernelError(f"nvcc failed on {s.name} "
                                  f"({proc.returncode}):\n{err}")
            reports.append(f"== {s.name}\n{err}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise KernelError(f"nvcc link failed ({link.returncode}):\n"
                              f"{link.stderr}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for o in objs:
            o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib)
    PTXAS_LOG.write_text("".join(reports))
    stamp.write_text(digest)
    return lib, seconds


def ptxas_log():
    """``ptxas -v``'s lines of the last build: per kernel, registers, shared
    memory and spill stores/loads."""
    return PTXAS_LOG.read_text() if PTXAS_LOG.exists() else ""


@functools.lru_cache(maxsize=1)
def library():
    """The loaded kernel library (built at first use)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc, what):
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc}")


def stream_handle(device):
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
