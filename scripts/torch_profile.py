#!/usr/bin/env python3
"""Where the time goes in the torch port's person_detect forward, or
train step, on one CUDA card (an H100).

    python3 scripts/torch_profile.py [--backend auto] [--batch 8192] [--iters 3] [--trace PATH]
    python3 scripts/torch_profile.py --train [--backend xla|pallas] [--batch 1024]
    python3 scripts/torch_profile.py --serve f32,int8_host,int8_device [--iters 3]

Runs ``predict_inner`` of ``microflow_tpu_torch`` (``--backend``: ``auto``,
the default, is the flat whole-network kernel on CUDA; ``pallas`` the
per-op kernels; ``fused``, ``hybrid`` and ``packed`` the megakernel and
packed-pipeline backends; ``xla`` the plain torch ops) under
``torch.profiler`` and
prints one JSON line:
the wall time per forward, the device-busy share of it, device time per
kernel name grouped into the port's kernels and PyTorch's own, and the
top PyTorch operators by device time.  ``--train`` times
``predict_quantized_train`` of ``person_detect_trainable(10)`` instead (one
train step: the forward, the backward and the fold; the keys still say
"forward").  ``--serve KINDS`` profiles ``chip_smoke.py`` phase 9's load
instead: 16 client threads of person_detect requests (1-300 rows, one of
1500) through a ``BatchServer`` with ``max_batch`` 1024, the kinds of
request in turn (host ``f32``, ``int8_host``, ``int8_device``); "forward"
is then one load, and ``--batch`` is not used.  ``--trace`` also writes
the Chrome trace.  Needs CUDA; fails without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from microflow_tpu_torch.models import person_detect, person_detect_trainable  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="auto",
                    help="auto, flat, pallas, fused, hybrid, packed or xla")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--trace", help="write the Chrome trace to this path")
    ap.add_argument("--train", action="store_true",
                    help="profile a train step of person_detect_trainable(10)")
    ap.add_argument("--serve", metavar="KINDS",
                    help="profile chip_smoke.py phase 9's BatchServer load of these request "
                         "kinds (comma-separated: f32, int8_host, int8_device)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: CUDA is not available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(0)
    server = None
    if args.serve:
        import chip_smoke
        from microflow_tpu_torch.parallel import BatchServer

        m = person_detect(backend=args.backend)
        server = BatchServer(m, max_batch=chip_smoke.SERVE_MAX_BATCH)
        requests = chip_smoke.serve_requests(
            m, rng, torch.device("cuda"), chip_smoke.SERVE_CLIENTS, chip_smoke.SERVE_PER_CLIENT,
            chip_smoke.SERVE_BIG, tuple(args.serve.split(",")))
        rows = sum(x.shape[0] for reqs in requests for _, x in reqs)

        def call():
            chip_smoke.serve_load(server, requests)
    elif args.train:
        xq = torch.from_numpy(rng.integers(-128, 128, (args.batch, 96, 96, 1),
                                           dtype=np.int8)).cuda()
        m = person_detect_trainable(10, backend=args.backend)
        gt = torch.full((args.batch, 2), -128, dtype=torch.int8)
        gt[torch.arange(args.batch), torch.from_numpy(rng.integers(0, 2, args.batch))] = 127
        gt = gt.cuda()

        def call():
            m.predict_quantized_train(xq, gt, 0.05)
    else:
        xq = torch.from_numpy(rng.integers(-128, 128, (args.batch, 96, 96, 1),
                                           dtype=np.int8)).cuda()
        m = person_detect(backend=args.backend)

        def call():
            m.predict_inner(xq)
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    extra = {}
    if server is not None:
        server.stop()
        extra = {"requests_per_load": sum(map(len, requests)), "rows_per_load": rows,
                 "inferences_per_s_profiled": rows / wall_ms * 1e3, "stats": server.stats()}

    kernels: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.device_time_total / 1e3
    per_fwd = {k: v / args.iters for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])}
    ours = {k: v for k, v in per_fwd.items()
            if any(n in k for n in ("qgemm", "qdwconv_tile", "qdwconv_general", "flat_kernel",
                                    "segment_kernel", "packed_kernel"))}
    device_ms = sum(per_fwd.values())
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    top_ops = [{"op": e.key, "device_ms_per_forward": e.self_device_time_total / 1e3 / args.iters,
                "calls_per_forward": e.count / args.iters} for e in ops[:15]
               if e.self_device_time_total > 0]
    if args.trace:
        prof.export_chrome_trace(args.trace)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({
        "model": "person_detect",
        "call": (f"BatchServer load ({args.serve})" if args.serve
                 else "train step" if args.train else "predict_inner"),
        "backend": m.backend, "batch": None if args.serve else args.batch, "device": smi,
        "wall_ms_per_forward": wall_ms, "device_ms_per_forward": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "port_kernels_ms_per_forward": sum(ours.values()),
        "other_kernels_ms_per_forward": device_ms - sum(ours.values()),
        "kernels_ms_per_forward": {k[:120]: v for k, v in list(per_fwd.items())[:25]},
        "top_ops": top_ops, **extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
