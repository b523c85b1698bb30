"""The control of the check that decides ``correct``: each cell at its own
size on the card, with the plain reference computed with int4 weights put
in the program's place, on several seeds in one process; or, with
``--fault NAME``, the program with that fault of ``faults.py`` planted.
Prints one JSON line a run with each compared number beside its limit;
every run has to come out not correct.  The benchmark's own runs never
run it.

    python3 benchmark/control.py --workload person_detect.score --seeds 1 2 3 [--seconds 2]
        [--fault half_batch]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None, help="a fault of faults.py instead of the control")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from benchmark.faults import FAULTS
    from benchmark.harness import load_data, run_cell

    patch = None
    if args.fault:
        patch = FAULTS[load_data("workloads", args.workload)["driver"]][args.fault]
    for seed in args.seeds:
        r = run_cell(args.workload, seed, args.seconds, False, torch.device("cuda", 0),
                     time.perf_counter(), control=patch is None, patch=patch)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": patch is None, "fault": args.fault,
                          "correct": r["correct"], "checks": r["checks"],
                          "device": r["device"]["kind"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
