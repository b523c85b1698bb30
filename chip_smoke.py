#!/usr/bin/env python3
"""Smoke run of the torch port (``microflow_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA card (an H100:
the kernels are built for ``sm_90a``).  Phases, each printing one JSON
line; any failure raises and the script exits non-zero:

1. device: CUDA must be present; the card's name and power limit.
2. build: both kernels from ``microflow_tpu_torch/csrc/`` with ``nvcc``.
3. kernels: each kernel held bit-equal against its plain torch version at
   every layer shape of sine, speech and person_detect (batch 64) and on
   edge cases; then timed at person_detect's shapes at batch 8192 beside
   its plain version, ``torch._int_mm`` (qgemm only) and its bound.
4. main path: the three Rust goldens through ``compile_tflite(...)`` with
   the default backend (the kernels on CUDA), with the launch counts of
   the person_detect requests.
5. whole model: the kernel backend bit-equal to the plain torch backend
   on random int8 inputs, batch 1024, all three models.
6. throughput: person_detect ``predict_inner`` inferences/s at batch 8192
   and 32768.

Then the kernels line, the ``nvidia-smi`` name/power-limit line, and, last,
``{"ok": true, "device": {...}}``.  In the kernels line ``launches`` is the
count from phase 4's requests; ``ms``, ``plain_ms``, ``bound_ms`` and
``library_ms`` are sums over the kernel's 14 launches in one person_detect
forward at batch 8192 (phase 3, per launch in the ``kernel_times`` line).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import microflow_tpu_torch.kernels as kernels
from microflow_tpu_torch import compile_tflite
from microflow_tpu_torch.core.activation import FusedActivation
from microflow_tpu_torch.kernels import LAUNCHES, build
from microflow_tpu_torch.models import GOLDENS, model_path

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# int8 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

MODELS = ("sine", "speech", "person_detect")
KERNEL_INFO = {
    "qgemm": {"source": "microflow_tpu_torch/csrc/qgemm.cu",
              "replaces": "microflow_tpu/kernels/qgemm.py:63"},
    "qdwconv": {"source": "microflow_tpu_torch/csrc/qdwconv.cu",
                "replaces": "microflow_tpu/kernels/qdwconv.py:81"},
}
ACTS = (FusedActivation.NONE, FusedActivation.RELU, FusedActivation.RELU6)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Recorder:
    """Stands in for ``kernels.qgemm``/``kernels.qdwconv`` while a model
    runs, so every call the builder makes is seen with its real inputs.
    ``mode="check"`` launches the kernel and its plain version on the same
    inputs and records the largest difference; ``mode="capture"`` keeps
    the inputs for timing."""

    def __init__(self, mode: str):
        self.mode = mode
        self.calls = {"qgemm": [], "qdwconv": []}
        self._orig = {}

    def __enter__(self):
        for name in self.calls:
            self._orig[name] = getattr(kernels, name)
            setattr(kernels, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(kernels, name, fn)

    def _wrap(self, name):
        def call(*args, **kw):
            out = self._orig[name](*args, **kw)
            if self.mode == "check":
                ref = getattr(kernels, f"{name}_reference")(*args, **kw)
                self.calls[name].append({"shape": _shape(name, args, kw),
                                         "max_abs_err": max_abs_err(out, ref)})
            else:
                self.calls[name].append((args, kw))
            return out

        return call


def _shape(name, args, kw) -> dict:
    if name == "qgemm":
        (m, k), n = args[0].shape, args[1].shape[1]
        return {"M": m, "K": k, "N": n, "act": kw["activation"].value}
    b, hp, wp, c = args[0].shape
    return {"B": b, "HP": hp, "WP": wp, "C": c, "kh": kw["kh"], "kw": kw["kw"],
            "sr": kw["sr"], "sc": kw["sc"], "act": kw["activation"].value}


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype mismatch {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item()) if a.numel() else 0


def random_input(model, batch: int, rng) -> torch.Tensor:
    g = model.graph
    x = rng.integers(-128, 128, (batch, *g.input_shape), dtype=np.int8)
    return torch.from_numpy(x).to(model.device)


# --- edge cases ---------------------------------------------------------------


def _round_away(y: np.ndarray) -> np.ndarray:
    t = np.trunc(y)
    return t + np.sign(y) * (np.abs(y - t) >= 0.5)


def epilogue_triples(rng, n: int):
    """(q, bias0, c1) triples that stress the epilogue y = bias0 + c1*q:
    y on and within an ulp of +-0.5 and +-k.5, far past the int8 rails,
    and triples where a fused multiply-add would round to another integer
    than a multiply and then an add.  Returns them and the count of the
    last kind."""
    q, b0, c1 = [], [], []
    for k in (-3, -1, 0, 1, 2, 126, -129):  # c1 = 1: y = k + bias0
        for h in (np.float32(0.5), np.float32(-0.5)):
            for b in (h, np.nextafter(h, np.float32(0)), np.nextafter(h, 2 * h)):
                q.append(k)
                b0.append(b)
                c1.append(1.0)
    for qq, bb in ((10**6, 0.0), (-(10**6), 0.0), (0, 1e9), (0, -1e9)):
        q.append(qq)
        b0.append(bb)
        c1.append(0.37)
    m = 4_000_000
    rq = rng.integers(-(2**20), 2**20, m)
    rc = rng.uniform(1e-4, 0.05, m).astype(np.float32)
    rb = rng.uniform(-150.0, 150.0, m).astype(np.float32)
    qf = rq.astype(np.float32)
    sep = rb + rc * qf  # f32 multiply, then f32 add
    fma = (rb.astype(np.float64) + rc.astype(np.float64) * qf.astype(np.float64)).astype(np.float32)
    hit = np.nonzero(_round_away(sep) != _round_away(fma))[0][:64]
    pick = np.concatenate([hit, rng.integers(0, m, max(0, n - len(q) - len(hit)))])
    q += rq[pick].tolist()
    b0 += rb[pick].tolist()
    c1 += rc[pick].tolist()
    return (np.array(q, np.int64), np.array(b0, np.float32), np.array(c1, np.float32),
            len(hit))


def edge_cases(dev, rng) -> dict:
    errs = {"qgemm": [], "qdwconv": []}

    def check(name, args, kw, label):
        out = getattr(kernels, name)(*args, **kw)
        ref = getattr(kernels, f"{name}_reference")(*args, **kw)
        errs[name].append({"case": label, "max_abs_err": max_abs_err(out, ref)})

    i8 = lambda shape: torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).to(dev)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    # epilogue: X = 0 makes q = d[n], so each column carries one triple
    q, b0, c1, n_fma = epilogue_triples(rng, 1024)
    n = len(q)
    for act in ACTS:
        kw = dict(activation=act, out_scale=0.05, out_zp=-3)
        check("qgemm", (torch.zeros((5, 4), dtype=torch.int8, device=dev),
                        i8((4, n)), i32(np.zeros(n)), i32(q), f32(b0), f32(c1)), kw,
              f"epilogue {act.value} ({n_fma} fma-sensitive)")
    # K not a multiple of 4 or 16, per-column w_zp, all activations
    for (M, K, N) in ((5, 37, 11), (300, 1, 16), (77, 5, 33), (64, 4000, 4), (1000, 18, 70),
                      (513, 130, 129)):
        for act in ACTS:
            kw = dict(activation=act, out_scale=float(rng.uniform(0.01, 0.1)),
                      out_zp=int(rng.integers(-20, 20)))
            check("qgemm", (i8((M, K)), i8((K, N)), i32(rng.integers(-9, 9, N)),
                            i32(rng.integers(-5000, 5000, N)), f32(rng.normal(0, 20, N)),
                            f32(rng.uniform(1e-4, 0.01, N))), kw, f"M{M} K{K} N{N} {act.value}")
    # depthwise: odd channel counts (scalar path), the 10x8/s2 stem, strides
    for (B, HP, WP, C, kh, kw_, sr, sc) in ((3, 11, 11, 5, 3, 3, 2, 2), (2, 58, 47, 8, 10, 8, 2, 2),
                                             (4, 9, 9, 12, 3, 3, 1, 1), (2, 13, 10, 3, 3, 2, 2, 1)):
        oh, ow = (HP - kh) // sr + 1, (WP - kw_) // sc + 1
        for act in ACTS:
            wc = torch.from_numpy(rng.integers(-255, 256, (kh, kw_, C)).astype(np.int32)).to(dev)
            kw = dict(kh=kh, kw=kw_, sr=sr, sc=sc, oh=oh, ow=ow, activation=act,
                      out_scale=float(rng.uniform(0.01, 0.1)), out_zp=int(rng.integers(-20, 20)))
            check("qdwconv", (i8((B, HP, WP, C)), wc, i32(rng.integers(-3000, 3000, C)),
                              f32(rng.normal(0, 20, C)), f32(rng.uniform(1e-4, 0.01, C))), kw,
                  f"{kh}x{kw_}/({sr},{sc}) C{C} {act.value}")
    return errs


# --- timing -------------------------------------------------------------------


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(name, args, kw, out) -> tuple[float, str, int, int]:
    """Least time for the call: (bytes moved at HBM rate) vs (operations at
    the int8 peak), the larger; each input read once, the output written
    once."""
    nbytes = sum(t.numel() * t.element_size() for t in args) + out.numel()
    if name == "qgemm":
        (m, k), n = args[0].shape, args[1].shape[1]
        ops = 2 * m * k * n
    else:
        ops = 2 * out.numel() * kw["kh"] * kw["kw"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def int_mm_call(args):
    """``torch._int_mm`` on the same product; K and N are zero-padded to
    what it accepts (multiples of 8, K >= 16) outside the timed call."""
    x, w = args[0], args[1]
    (m, k), n = x.shape, w.shape[1]
    kp, np_ = max(16, -(-k // 8) * 8), -(-n // 8) * 8
    if (kp, np_) != (k, n):
        x = torch.nn.functional.pad(x, (0, kp - k))
        w = torch.nn.functional.pad(w, (0, np_ - n, 0, kp - k))
    return lambda: torch._int_mm(x, w)


def time_kernels(calls) -> dict:
    """Per-call times at the captured shapes; sums per kernel."""
    res = {}
    for name, lst in calls.items():
        rows = []
        for args, kw in lst:
            kern = getattr(kernels, name)
            ref = getattr(kernels, f"{name}_reference")
            out = kern(*args, **kw)
            err = max_abs_err(out, ref(*args, **kw))
            t_bound, by, nbytes, ops = bound(name, args, kw, out)
            row = {"shape": _shape(name, args, kw), "max_abs_err": err,
                   "ms": time_ms(lambda: kern(*args, **kw), 20),
                   "plain_ms": time_ms(lambda: ref(*args, **kw), 3, warmup=1),
                   "bound_ms": t_bound, "bound_by": by, "bytes": nbytes, "ops": ops,
                   "library_ms": None}
            if name == "qgemm":
                row["library_ms"] = time_ms(int_mm_call(args), 20)
            rows.append(row)
        tot = lambda key: sum(r[key] for r in rows)
        res[name] = {
            "ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
            "bound_by": "bytes" if sum(r["bound_by"] == "bytes" for r in rows) * 2 >= len(rows)
            else "operations",
            "library_ms": tot("library_ms") if name == "qgemm" else None,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "launches_per_forward": len(rows), "per_call": rows,
        }
    return res


# --- phases -------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.time()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    t = time.time()
    paths = build.build_all()
    ptxas = {}
    for name, path in paths.items():
        with open(path + ".log") as f:
            ptxas[name] = [ln.strip() for ln in f if "registers" in ln]
    emit({"phase": "build", "seconds": round(time.time() - t, 3), "ptxas": ptxas})

    # 3. kernels against their plain versions
    rng = np.random.default_rng(0)
    with Recorder("check") as rec:
        for name in MODELS:
            m = compile_tflite(model_path(name), name=name, backend="pallas")
            m.predict_inner(random_input(m, 64, rng))
    shape_errs = rec.calls
    edge = edge_cases(dev, rng)
    torch.cuda.synchronize()
    errs = {k: max([c["max_abs_err"] for c in shape_errs[k] + edge[k]]) for k in shape_errs}
    emit({"phase": "kernels_vs_plain", "tolerance": "bit-equal (max_abs_err 0)",
          "max_abs_err": errs,
          "checks": {k: len(shape_errs[k]) + len(edge[k]) for k in errs},
          "model_shapes": {k: len(shape_errs[k]) for k in errs}})
    if any(errs.values()):
        raise AssertionError(f"kernel differs from its plain version: {errs}")

    pd = compile_tflite(model_path("person_detect"), name="person_detect")
    with Recorder("capture") as rec:
        pd.predict_inner(random_input(pd, 8192, rng))
    timing = time_kernels(rec.calls)
    del rec
    torch.cuda.empty_cache()
    if any(timing[k]["max_abs_err"] for k in timing):
        raise AssertionError("kernel differs from its plain version at batch 8192")
    emit({"phase": "kernel_times", "batch": 8192, "device": smi, **timing})

    # 4. main path: goldens through the default backend; launch counts of
    # the person_detect requests
    goldens = {}
    for name in MODELS:
        x, want = GOLDENS[name]
        m = compile_tflite(model_path(name), name=name)
        if m.backend != "pallas":
            raise AssertionError(f"default backend on CUDA is {m.backend!r}, not the kernels")
        if name == "person_detect":
            LAUNCHES.clear()
            got = m.predict(x).cpu().numpy()
            reqs = [m.predict(rng.uniform(0, 1, (b, 96, 96, 1)).astype(np.float32))
                    for b in (1, 3, 16)]
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
            if not all(np.isfinite(r.cpu().numpy()).all() for r in reqs):
                raise AssertionError("person_detect: non-finite output")
        else:
            got = m.predict(x).cpu().numpy()
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{name} golden mismatch: {got} != {want}")
        goldens[name] = got.ravel().tolist()
    per_forward = {"qgemm": 14, "qdwconv": 14}
    for k, n in per_forward.items():
        if launches.get(k, 0) != 4 * n:
            raise AssertionError(f"main path launched {k} {launches.get(k, 0)} times, "
                                 f"expected {4 * n} (4 requests)")
    emit({"phase": "main_path", "goldens_bit_exact": goldens, "launches": launches,
          "requests": 4})

    # 5. whole model: kernels vs plain torch ops on the card
    whole = {}
    for name in MODELS:
        mk = compile_tflite(model_path(name), name=name, backend="pallas")
        mx = compile_tflite(model_path(name), name=name, backend="xla")
        xq = random_input(mk, 1024, rng)
        yk, yx = mk.predict_inner(xq), mx.predict_inner(xq)
        whole[name] = {"shape": list(yk.shape), "max_abs_err": max_abs_err(yk, yx)}
        del mx
    torch.cuda.empty_cache()
    emit({"phase": "whole_model_vs_plain", "batch": 1024, **whole})
    if any(v["max_abs_err"] for v in whole.values()):
        raise AssertionError(f"kernel backend differs from the plain backend: {whole}")

    # 6. throughput
    thr = {}
    for batch in (8192, 32768):
        xq = random_input(pd, batch, rng)
        ms = time_ms(lambda: pd.predict_inner(xq), 10 if batch == 8192 else 5, warmup=2)
        thr[str(batch)] = {"ms_per_batch": ms, "inferences_per_s": batch / ms * 1e3}
        del xq
        torch.cuda.empty_cache()
    emit({"phase": "throughput", "model": "person_detect", "backend": pd.backend,
          "device": smi, "clocks_power": nvidia_smi("clocks.sm,power.draw,power.limit"), **thr})
    emit({"phase": "done", "seconds": round(time.time() - t_start, 1)})

    emit({"kernels": [
        {"name": k, "route": "cuda", **KERNEL_INFO[k], "launches": launches[k],
         "max_abs_err": max(errs[k], timing[k]["max_abs_err"]), "ms": timing[k]["ms"],
         "plain_ms": timing[k]["plain_ms"], "bound_ms": timing[k]["bound_ms"],
         "bound_by": timing[k]["bound_by"], "library_ms": timing[k]["library_ms"]}
        for k in ("qgemm", "qdwconv")]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
