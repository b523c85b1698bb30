"""Find the highest rate ``person_detect.serve``'s mix sustains: offer a
rising series of fixed rates to one server, in one process, and report at
each the rows offered and completed a second, the backlog at the close,
how long the backlog took to drain, the latency quantiles and how late the
generator ran.

    python3 benchmark/serve_sweep.py --rates 200 400 600 800 --seconds 8 [--repeats 3] [--seed N]
        [--workload person_detect.serve] [--out chiprun_out/serve_sweep.jsonl]

A rate is sustained where the completed rows keep pace with the offered
rows and the backlog does not grow over the window (it drains within a
few batches).  The cell's rate is fixed at about four fifths of the
highest sustained one, as a number in its workload file.  Needs the card;
fails without it.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def sweep_context(workload_name: str, seed: int, seconds: float, device, overrides=None):
    """The harness's ``Context`` for ``workload_name`` (its serve driver),
    with the workload's traffic parameters and ``overrides``; the sweep
    sets ``rate_rps`` in them rate by rate."""
    from benchmark.harness import Context, load_data

    workload = load_data("workloads", workload_name)
    return Context(workload_name, workload, load_data("configs", workload["config"]),
                   params={**workload["traffic"], **(overrides or {})}, seed=seed,
                   device=device, seconds=seconds)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="person_detect.serve")
    ap.add_argument("--rates", type=float, nargs="+", required=True, help="requests a second")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--repeats", type=int, default=1, help="windows at each rate, in turn")
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--out", default=None, help="also append each line to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("serve_sweep: no CUDA device", file=sys.stderr)
        return 2
    from benchmark.drivers.serve import Cell
    from benchmark.harness import Window, collector_log

    ctx = sweep_context(args.workload, args.seed, args.seconds, torch.device("cuda", 0))
    cell = Cell(ctx)
    cell.setup()
    collections: list = []  # [start, end, generation] of each garbage collection
    gc.callbacks.append(collector_log(collections))
    try:
        for rate in [r for r in args.rates for _ in range(args.repeats)]:
            ctx.params["rate_rps"] = rate
            ctx.counters.clear()
            cell.plan(args.seconds)
            gc.collect()  # as the harness does before a window
            gc.freeze()
            collections.clear()
            e2e = cell.window(Window(args.seconds, ctx.device, None))
            c = ctx.counters
            line = {"rate_rps": rate, "seconds": args.seconds,
                    "offered_rows_per_s": c["rows"] / args.seconds,
                    "completed_rows_per_s": e2e["served_rows_per_s"],
                    "backlog_rows_end": c["backlog_rows_end"],
                    "queue_depth_end": c["queue_depth_end"], "drain_s": c["drain_s"],
                    "p50_ms": e2e["serve_p50_ms"], "p95_ms": e2e["serve_p95_ms"],
                    "late_p99_ms": c["late_p99_ms"], "failed": cell.failed,
                    "gc_full": sum(g == 2 for _, _, g in collections),
                    "gc_longest_ms": 1e3 * max((b - a for a, b, _ in collections if b), default=0),
                    "rows_per_batch": (c["stats_window"]["inferences_completed"]
                                       / max(c["stats_window"]["batches_dispatched"], 1)),
                    "device": torch.cuda.get_device_name(0), "at": time.time()}
            print(json.dumps(line), flush=True)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    finally:
        cell.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
