#!/usr/bin/env python3
"""Where the time goes inside the flat whole-network kernel on one CUDA card
(an H100): the kernel is one launch, so a profiler sees only its total.

    python3 scripts/torch_flat_layers.py [--model person_detect] [--batch 8192] [--iters 10]

Builds the kernel of every prefix of the model's flat plan
(``build_flat_kernel(graph, max_layers=k)``, k = 2 .. n_layers), times each
with CUDA events on the same input, and prints one JSON line: per op its
layer, kind, output shape, multiply-adds per sample, and its marginal time
(the prefix ending at it minus the prefix before; the first two ops are
timed together, since a plan needs two).  A prefix also writes its last
tensor to device memory, so a marginal time includes the difference of
two output copies.  Needs CUDA; fails without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from microflow_tpu_torch import parse  # noqa: E402
from microflow_tpu_torch.kernels import build_flat_kernel  # noqa: E402
from microflow_tpu_torch.models import model_path  # noqa: E402


def time_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="person_detect")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flat_layers: CUDA is not available", file=sys.stderr)
        return 1
    g = parse(model_path(args.model))
    full, n_layers, meta = build_flat_kernel(g, device="cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-128, 128, (args.batch, meta["in_lanes"]),
                                      dtype=np.int8)).cuda()
    ops = full.ops
    prefix_ms = {}
    for op in ops[1:]:
        k = op.layer_idx + 1
        flat_fn, n, _ = build_flat_kernel(g, max_layers=k, device="cuda")
        prefix_ms[n] = time_ms(lambda: flat_fn(x), args.iters)
    rows, prev = [], 0.0
    for i, op in enumerate(ops):
        n = op.layer_idx + 1
        ms = prefix_ms.get(n)
        if ms is None:  # the first op: timed with the second
            continue
        joined = ops[:2] if i == 1 else [op]
        rows.append({"layers": [o.layer_idx for o in joined], "kinds": [o.kind for o in joined],
                     "out_shape": list(op.out_shape),
                     "macs_per_sample": sum(o.macs() for o in joined),
                     "marginal_ms": ms - prev, "prefix_ms": ms})
        prev = ms
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    by_kind: dict[str, float] = {}
    for r in rows:
        key = "+".join(sorted(set(r["kinds"])))
        by_kind[key] = by_kind.get(key, 0.0) + r["marginal_ms"]
    print(json.dumps({"model": args.model, "batch": args.batch, "device": smi,
                      "n_layers": n_layers, "whole_ms": prefix_ms[n_layers],
                      "marginal_ms_by_kind": by_kind, "ops": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
