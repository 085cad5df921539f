"""Run one cell of the benchmark of ``plonky2_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
See ``harness/main.py``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench-cache"

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    # Kernel caches at fixed paths inside the checkout, so that only a
    # checkout's first run builds (the port's nvcc build already lives
    # under build/).
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    from portbench.harness.main import main

    sys.exit(main(sys.argv[1:], T_START))
