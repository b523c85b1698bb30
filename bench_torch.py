#!/usr/bin/env python
"""Throughput benchmark of the PyTorch/CUDA port (``microflow_tpu_torch``):
person_detect (MobileNet-v1 0.25x int8) inferences per second on one card.

    python bench_torch.py [--model models/person_detect.tflite] [--batch 8192]
                          [--iters 200] [--backend NAME] [--seed 0]

Prints ONE JSON line to stdout, with the keys of ``bench.py``'s line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

It checks the model's Rust-reference golden first (for the three bundled
models) and on a mismatch prints the ``<model>_parity`` line and exits 1.
Then it times ``predict_inner`` on int8 inputs drawn from a
``torch.Generator`` seeded with ``--seed``, with CUDA events around
``--iters`` calls after a warm-up.  Baseline: the reference MicroFlow Rust
engine's best per-chip rate, 896,216 us per inference on an nRF52840 =
1.1158 inf/s.  Diagnostics go to stderr: the card's name and power limit,
the backend, the batch, ms per batch, MACs per inference and TMAC/s.

``--device cpu`` and ``--smoke`` (batch 64, 3 iterations, backend ``xla``)
exist for the CPU tests; nothing falls back to the CPU on its own, and a
CPU run's metric is named ``<model>_inferences_per_sec_cpu``.  The port
imports no JAX, and neither does this script.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

BASELINE_INF_PER_S = 1.0 / 0.896216  # person_detect, nRF52840

# H100 SXM published dense int8 tensor-core peak (NVIDIA data sheet), at the
# full 700 W power limit
H100_INT8_OPS_PER_S = 1.979e15

# Rust-reference goldens (tests/{sine,speech,person_detect}.rs), keyed by
# model *name* so user models with colliding input shapes are never
# mis-compared (a (96,96,1) user model must not be judged against the
# person_detect golden).
GOLDENS = {
    "sine": (np.array([[0.5]], np.float32),
             np.array([[0.41348344]], np.float32)),
    "speech": (np.full((1, 1960), 0.5, np.float32),
               np.array([[0.15625, 0.2734375, 0.2734375, 0.296875]], np.float32)),
    "person_detect": (np.full((1, 96, 96, 1), 0.5, np.float32),
                      np.array([[0.8046875, 0.1953125]], np.float32)),
}


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def select_golden(model_name, input_shape):
    """Return (input, expected) for a bundled model, else None."""
    entry = GOLDENS.get(model_name)
    if entry is not None and entry[0].shape[1:] == tuple(input_shape):
        return entry
    return None


def card(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    index = device.index if device.index is not None else 0
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="models/person_detect.tflite")
    ap.add_argument("--batch", type=int, default=8192,
                    help="samples a call (default 8192: the flat kernel read 2.53-2.55M "
                         "inferences/s at 8192 and 2.52-2.56M at 32768 on an H100 80GB HBM3 "
                         "at 700 W, so 8192 gives the same reading for a quarter of the card "
                         "time)")
    ap.add_argument("--iters", type=int, default=200, help="timed calls (default 200)")
    ap.add_argument("--backend", default=None,
                    help="a backend of the port's builder (default: MFT_BACKEND, else auto: "
                         "flat on the card for person_detect)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the int8 inputs")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu is for the tests)")
    ap.add_argument("--smoke", action="store_true",
                    help="CPU-test smoke: batch 64, 3 iterations, backend xla; still prints "
                         "the one JSON line")
    args = ap.parse_args(argv)
    if args.smoke:
        args.batch, args.iters = 64, 3
        args.backend = args.backend or "xla"

    from microflow_tpu_torch import compile_tflite
    from microflow_tpu_torch.utils import macs_per_inference, time_predict

    model_name = os.path.splitext(os.path.basename(args.model))[0]
    model = compile_tflite(args.model, name=model_name, backend=args.backend,
                           device=args.device)
    where = card(model.device) if model.device.type == "cuda" else "cpu"
    macs = macs_per_inference(model.graph)
    log(f"device: {where}; backend: {model.backend}")
    log(f"model: {args.model} ({len(model.graph.layers)} layers, "
        f"{macs / 1e6:.2f} MMACs/inference)")

    # parity guard: golden output must match the Rust reference bit-for-bit
    entry = select_golden(model_name, model.graph.input_shape)
    if entry is not None:
        gin, expected = entry
        golden = model.predict(gin).cpu().numpy()
        if not np.array_equal(golden, expected):
            log(f"PARITY FAILURE ({model_name}): {golden} != {expected}")
            print(json.dumps({"metric": f"{model_name}_parity", "value": 0, "unit": "bool",
                              "vs_baseline": 0}))
            return 1
        log(f"parity: {model_name} golden output bit-exact vs Rust reference")
    else:
        log("parity: no golden for this model (skipped)")

    r = time_predict(model, args.batch, args.iters, seed=args.seed)
    inf_per_s = r["inferences_per_s"]
    line = (f"batch={r['batch']}: {r['ms_per_batch']:.4f} ms/batch, {inf_per_s:,.0f} inf/s, "
            f"{r['tmacs_per_s']:.3f} TMAC/s")
    if model.device.type == "cuda":
        line += (f" ({2 * r['tmacs_per_s'] * 1e12 / H100_INT8_OPS_PER_S * 100:.2f}% of the "
                 f"H100 SXM's dense int8 peak; card: {where})")
    log(line)
    # a CPU run's rate is no device metric: it is named for the CPU
    per = "per_chip" if model.device.type == "cuda" else "cpu"
    print(json.dumps({
        "metric": f"{model_name}_inferences_per_sec_{per}",
        "value": round(inf_per_s, 1),
        "unit": "inferences/s",
        "vs_baseline": round(inf_per_s / BASELINE_INF_PER_S, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
