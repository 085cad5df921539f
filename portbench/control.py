"""Each control of ``harness/control.py`` in the system's place, on a cell's
own plan, on several seeds: its readings of the numbers that decide
``correct`` (each must exceed its limit of 0 on some number for the control
to come out not correct).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 1]

prints one JSON line: {"workload", "readings": {control: {seed: {check:
lanes wrong}}}, "all_caught": bool}; exits 1 unless every control is
caught on every seed. Runs on the CPU; the benchmark's runs never run it.
"""

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench.harness import control

    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    readings = control.summary(args.workload, seeds, args.seconds)
    caught = all(any(v > 0 for v in r.values())
                 for by_seed in readings.values() for r in by_seed.values())
    print(json.dumps({"workload": args.workload, "readings": readings,
                      "all_caught": caught}))
    sys.exit(0 if caught else 1)
