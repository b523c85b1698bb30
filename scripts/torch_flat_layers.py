#!/usr/bin/env python3
"""Where the time goes inside a whole-network kernel on one CUDA card (an
H100): the flat kernel, the megakernel or the packed kernel is one launch,
so a profiler sees only its total.

    python3 scripts/torch_flat_layers.py [--kernel flat] [--model person_detect]
                                         [--batch 8192] [--iters 10]

Builds the kernel of every prefix of the model's plan (``--kernel flat``:
``build_flat_kernel(graph, max_layers=k)``, k = 2 .. n_layers;
``megakernel``: the first k layers of the first segment of the ``fused``
forward; ``packed``: the first k ops of the packed plan), times each with
CUDA events on the same input, and prints one JSON line: per op its layer,
kind (``--kernel megakernel`` and ``packed``: its path in the kernel,
``op_path``), output shape, multiply-adds per sample, (``--kernel flat``)
the weight bytes a block loads per sample for a 1x1 conv (the tensor-core
path: its m-tile's A fragments once per work item of ``NT`` pixel tiles;
``op_pw``: one byte per multiply-add), and its marginal time (the
prefix ending at it minus the prefix before; the flat kernel's first two
ops are timed together, since a flat plan needs two).  A prefix also
writes its last tensor to device memory, so a marginal time includes the
difference of two output copies.  Needs CUDA; fails without it.
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
from microflow_tpu_torch.kernels import (  # noqa: E402
    build_flat_kernel,
    build_fused_forward,
    build_packed_kernel,
)
from microflow_tpu_torch.kernels import flatpack  # noqa: E402
from microflow_tpu_torch.kernels.megakernel import (  # noqa: E402
    Segment,
    SegmentKernel,
    layer_macs,
)
from microflow_tpu_torch.kernels.packed import PackedKernel  # noqa: E402
from microflow_tpu_torch.models import model_path  # noqa: E402


def weight_bytes(op) -> int | None:
    """Weight bytes a block of the flat kernel loads per sample for a 1x1
    conv; None for other ops."""
    if op.kind != "pw":
        return None
    if not flatpack.pw_mma(op.in_shape, op.out_shape):
        return op.macs()
    (oh, ow, oc), ic = op.out_shape, op.in_shape[2]
    chunks = -(-oh * ow // (8 * flatpack.NT))
    return chunks * oc * -(-ic // 32) * 32


def plan_prefixes(kernel: str, g):
    """``(ops, first, make, in_shape)``: per op of the plan (layer, kind,
    out_shape, multiply-adds a sample), the shortest prefix, the kernel of
    the first k ops (``make(k)``) and the per-sample input shape."""
    if kernel == "flat":
        full, _, meta = build_flat_kernel(g, device="cuda")
        ops = [(o.layer_idx, o.kind, o.out_shape, o.macs()) for o in full.ops]
        make = lambda k: build_flat_kernel(g, max_layers=ops[k - 1][0] + 1, device="cuda")[0]
        return ops, 2, make, (meta["in_lanes"],)
    if kernel == "megakernel":
        seg = build_fused_forward(g, device="cuda").segments[0]
        s = seg.segment
        ops = [(layer.index, path, shp[1], layer_macs(layer, shp[1]))
               for layer, shp, path in zip(s.layers, s.shapes, seg.paths)]
        make = lambda k: SegmentKernel(Segment(s.layers[:k], s.in_shape, s.shapes[k - 1][1],
                                               s.gather, s.shapes[:k]), seg.params, seg.device)
        return ops, 1, make, s.in_shape
    full = build_packed_kernel(g, device="cuda")[0]
    ops = [(o.layer_idx, path, (o.h_out, o.w_out, o.c_out), o.macs())
           for o, path in zip(full.ops, full.paths)]
    return ops, 1, lambda k: PackedKernel(g, full.ops[:k], full.device), full.in_shape


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
    ap.add_argument("--kernel", default="flat", choices=("flat", "megakernel", "packed"))
    ap.add_argument("--model", default="person_detect")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flat_layers: CUDA is not available", file=sys.stderr)
        return 1
    ops, first, make, in_shape = plan_prefixes(args.kernel, parse(model_path(args.model)))
    wbytes = {}
    if args.kernel == "flat":
        full, _, _ = build_flat_kernel(parse(model_path(args.model)), device="cpu")
        wbytes = {o.layer_idx: weight_bytes(o) for o in full.ops}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-128, 128, (args.batch, *in_shape), dtype=np.int8)).cuda()
    rows, prev = [], 0.0
    for k in range(first, len(ops) + 1):
        fn = make(k)
        ms = time_ms(lambda: fn(x), args.iters)
        joined = ops[:k] if k == first else ops[k - 1:k]
        rows.append({"layers": [o[0] for o in joined], "kinds": [o[1] for o in joined],
                     "out_shape": list(ops[k - 1][2]),
                     "macs_per_sample": sum(o[3] for o in joined),
                     "weight_bytes_per_sample": wbytes.get(ops[k - 1][0]),
                     "marginal_ms": ms - prev, "prefix_ms": ms})
        prev = ms
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    by_kind: dict[str, float] = {}
    for r in rows:
        key = "+".join(sorted(set(r["kinds"])))
        by_kind[key] = by_kind.get(key, 0.0) + r["marginal_ms"]
    pw_bytes = [b for b in wbytes.values() if b is not None]
    print(json.dumps({"kernel": args.kernel, "model": args.model, "batch": args.batch,
                      "device": smi, "n_ops": len(ops), "whole_ms": prev,
                      "pw_weight_bytes_per_sample": sum(pw_bytes) if pw_bytes else None,
                      "marginal_ms_by_kind": by_kind, "ops": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
