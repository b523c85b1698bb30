#!/usr/bin/env python3
"""A model's inferences/s through the port in two checkouts, in turns, on
one CUDA card (an H100): a change against its parent.

    python3 scripts/torch_ab.py PARENT CHANGE [--model person_detect]
                                [--backends flat pallas hybrid packed]
                                [--batches 8192 32768] [--rounds 1] [--seed 0]
                                [--device-time BACKEND ...]

PARENT and CHANGE are the roots of two checkouts (a ``git archive`` of each
will do).  The runs go parent, change, change, parent (``--rounds`` such
blocks), each in a fresh process that imports ``microflow_tpu_torch`` from
its checkout (and builds its kernels there on first use), compiles
``models/<model>.tflite`` with each backend, and times ``predict_inner`` on
the same random int8 inputs (from ``--seed``) with CUDA events after a
warm-up, as ``chip_smoke.py`` phase 6 does: 10 forwards at batch 8192 and
below, 5 above.  For each backend named in ``--device-time`` (one whose
forward is kernel launches alone, e.g. ``colfc`` or, on sine, ``flat``) it
also gives device ms a forward: 5 forwards captured in a CUDA graph,
replayed between two CUDA events, so the host's cost a call is not in it.
Prints one JSON line a run and, last, the per-side lists of ms per batch,
inferences/s (and device ms) for each backend and batch.  Needs CUDA; fails
without it.  ``--model sine --backends colfc pallas flat --batches 1048576
16777216 --device-time colfc flat`` compares the column-FC kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def events_ms(fn, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def child(root: str, model: str, backends: list[str], batches: list[int], seed: int,
          device_time: list[str]) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from microflow_tpu_torch import compile_tflite, parse
    from microflow_tpu_torch.models import model_path

    rng = np.random.default_rng(seed)
    shape = parse(model_path(model)).input_shape
    inputs = {b: torch.from_numpy(rng.integers(-128, 128, (b, *shape), dtype=np.int8)).cuda()
              for b in batches}
    out = {}
    for backend in backends:
        m = compile_tflite(model_path(model), name=model, backend=backend)
        for b, xq in inputs.items():
            for _ in range(2):
                m.predict_inner(xq)
            out[f"{backend}/{b}"] = events_ms(lambda: m.predict_inner(xq), 10 if b <= 8192 else 5)
            if backend in device_time:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    for _ in range(5):
                        m.predict_inner(xq)
                graph.replay()
                out[f"{backend}/{b}/device"] = events_ms(graph.replay, 1) / 5
                del graph
        del m
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--model", default="person_detect")
    ap.add_argument("--backends", nargs="+", default=["flat", "pallas", "hybrid", "packed"])
    ap.add_argument("--batches", nargs="+", type=int, default=[8192, 32768])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device-time", nargs="*", default=[])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.model, args.backends, args.batches, args.seed,
                               args.device_time)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_ab: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    sides = {"parent": os.path.abspath(args.parent), "change": os.path.abspath(args.change)}
    runs = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            cmd = [sys.executable, os.path.abspath(__file__), args.parent, args.change,
                   "--child", sides[side], "--model", args.model, "--backends", *args.backends,
                   "--batches", *map(str, args.batches), "--seed", str(args.seed),
                   "--device-time", *args.device_time]
            res = subprocess.run(cmd, capture_output=True, text=True, check=True, cwd=sides[side],
                                 timeout=1800)
            ms = json.loads(res.stdout.strip().splitlines()[-1])
            runs[side].append(ms)
            print(json.dumps({"side": side, "ms_per_batch": ms}), flush=True)
    summary = {}
    for key in runs["parent"][0]:
        if key.endswith("/device"):
            continue
        batch = int(key.split("/")[1])
        summary[key] = {side: {"ms_per_batch": [r[key] for r in runs[side]],
                               "inferences_per_s": [batch / r[key] * 1e3 for r in runs[side]]}
                        for side in runs}
        for side in runs:
            if f"{key}/device" in runs[side][0]:
                summary[key][side]["device_ms_per_batch"] = [r[f"{key}/device"]
                                                             for r in runs[side]]
    print(json.dumps({"model": args.model, "device": smi,
                      "order": "parent, change, change, parent", **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
