#!/usr/bin/env python3
"""Time variants of ``qgemm``'s tensor-core path (``qgemm_mma`` in
``microflow_tpu_torch/csrc/qgemm.cu``) at person_detect's shapes, on one
CUDA card.

    python3 scripts/torch_qgemm_sweep.py [--variants 2,4,3,1024 2,8,2,1024 ...]
                                         [--batch 8192] [--all-shapes]

Each variant ``T,MT,B,G`` is the source with its constants ``kTiles = T``
(tiles of 8 rows a warp's work item), ``kMaxTiles = MT`` (m-tiles of 16
output channels a block), ``kMinBlocks = B`` (``__launch_bounds__``'
blocks an SM) and ``kMaxBlocks = G`` (blocks) replaced; all are built in parallel
with ``kernels/build.py``'s flags into ``build/qgemm_sweep/``, and ``ptxas``
registers, stack and spills are printed for each.  Then at each of
person_detect's ``qgemm`` shapes with K >= 64 (``--all-shapes``: all 14,
K <= 32 forced onto the tensor cores too) every variant runs on the same
random inputs, is checked bit-equal to ``qgemm_reference``, and is timed
on the device (``chip_smoke.graph_ms``: 20 launches captured in a CUDA
graph, replayed between two CUDA events), the variants in turns and then
in reverse order; ``torch._int_mm`` on the same product
(``chip_smoke.int_mm_call``), and the ``__dp4a`` path of the first
variant, are timed the same way.  Prints one JSON line a shape and,
last, the sum over the shapes of each variant's mean time.  Needs CUDA
and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import graph_ms, int_mm_call  # noqa: E402
from microflow_tpu_torch.core.activation import FusedActivation, activation_bounds  # noqa: E402
from microflow_tpu_torch.kernels import build  # noqa: E402
from microflow_tpu_torch.kernels.qgemm import qgemm_reference  # noqa: E402

# person_detect's qgemm calls at batch 1: (rows per sample, K, N, launches)
PD_SHAPES = [(2304, 8, 16, 1), (576, 16, 32, 1), (576, 32, 32, 1), (144, 32, 64, 1),
             (144, 64, 64, 1), (36, 64, 128, 1), (36, 128, 128, 5), (9, 128, 256, 1),
             (9, 256, 256, 1), (1, 256, 2, 1)]
CONSTANTS = {"tiles": "kTiles", "max_tiles": "kMaxTiles", "min_blocks": "kMinBlocks",
             "max_blocks": "kMaxBlocks"}


def variant_source(src: str, values: dict) -> str:
    for key, name in CONSTANTS.items():
        src, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{values[key]};", src)
        if n != 1:
            raise RuntimeError(f"{name} not found once in qgemm.cu")
    return src


def build_variants(variants: list[dict]) -> dict:
    """name -> (ctypes function, ptxas usage of the qgemm_mma instantiations)."""
    import ctypes

    base = os.path.join(ROOT, "build", "qgemm_sweep")
    shutil.rmtree(base, ignore_errors=True)
    with open(os.path.join(build.CSRC, "qgemm.cu")) as f:
        src = f.read()
    procs = {}
    for v in variants:
        d = os.path.join(base, v["name"])
        os.makedirs(d)
        for h in ("epilogue.cuh", "mma_s8.cuh"):
            shutil.copy(os.path.join(build.CSRC, h), d)
        with open(os.path.join(d, "qgemm.cu"), "w") as f:
            f.write(variant_source(src, v))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
               os.path.join(d, "qgemm.cu")]
        procs[v["name"]] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        usage, fn = {}, None
        for ln in log.splitlines():
            if m := re.search(r"Compiling entry function '(\S*qgemm_mma\S*)'", ln):
                fn = re.search(r"qgemm_mmaILi(\d)E", m.group(1)).group(1)
            elif m := re.search(r"Compiling entry function", ln):
                fn = None
            elif fn and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)):
                usage.setdefault(f"VEC{fn}", {}).update(stack=int(m[1]), spill_stores=int(m[2]))
            elif fn and (m := re.search(r"Used (\d+) registers", ln)):
                usage.setdefault(f"VEC{fn}", {})["registers"] = int(m[1])
        lib = ctypes.CDLL(os.path.join(base, name, "lib.so"))
        symbol, argtypes = build.SIGNATURES["qgemm"]
        f = getattr(lib, symbol)
        f.argtypes, f.restype = argtypes, ctypes.c_int
        out[name] = (f, usage)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+",
                    default=["2,4,3,1024", "2,8,2,1024", "1,8,3,1024", "2,2,4,1024"])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--all-shapes", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_qgemm_sweep: CUDA is not available", file=sys.stderr)
        return 1
    variants = []
    for spec in args.variants:
        t, mt, b, g = (int(v) for v in spec.split(","))
        variants.append({"name": f"t{t}_m{mt}_b{b}_g{g}", "tiles": t, "max_tiles": mt,
                         "min_blocks": b, "max_blocks": g})
    libs = build_variants(variants)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ptxas": {n: u for n, (_, u) in libs.items()}}), flush=True)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    totals = {v["name"]: 0.0 for v in variants}
    for rows, K, N, launches in PD_SHAPES:
        if K < 64 and not args.all_shapes:
            continue
        M = rows * args.batch
        t = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(dev)
        x = t(rng.integers(-128, 128, (M, K)), np.int8)
        w = t(rng.integers(-128, 128, (K, N)), np.int8)
        wzp, d = t(np.zeros(N), np.int32), t(rng.integers(-5000, 5000, N), np.int32)
        b0, c1 = t(rng.normal(0, 20, N), np.float32), t(rng.uniform(1e-4, 1e-3, N), np.float32)
        kw = dict(activation=FusedActivation.RELU6, out_scale=0.05, out_zp=-3)
        lo, hi = activation_bounds(**kw)
        ref = qgemm_reference(x, w, wzp, d, b0, c1, **kw)
        out = torch.empty_like(ref)

        def call(f, path=1):
            return lambda: build.check(
                f(x.data_ptr(), w.data_ptr(), wzp.data_ptr(), d.data_ptr(), b0.data_ptr(),
                  c1.data_ptr(), out.data_ptr(), M, K, N, float(lo), float(hi),
                  int(K % 4 == 0), int(N % 4 == 0), path,
                  torch.cuda.current_stream().cuda_stream), "qgemm")

        row = {"M": M, "K": K, "N": N, "launches": launches, "ms": {}, "equal": {},
               "int_mm_ms": graph_ms(int_mm_call((x, w))),
               "dp4a_ms": graph_ms(call(libs[variants[0]["name"]][0], path=0))}
        for v in variants:
            out.zero_()
            call(libs[v["name"]][0])()
            row["equal"][v["name"]] = bool(torch.equal(out, ref))
        order = [v["name"] for v in variants]
        for name in order + order[::-1]:
            row["ms"].setdefault(name, []).append(graph_ms(call(libs[name][0])))
        for name, ms in row["ms"].items():
            totals[name] += launches * sum(ms) / len(ms)
        print(json.dumps(row), flush=True)
        if not all(row["equal"].values()):
            raise AssertionError(f"a variant differs from qgemm_reference: {row['equal']}")
        del x, w, ref, out
        torch.cuda.empty_cache()
    print(json.dumps({"sum_ms_by_variant": totals, "batch": args.batch}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
