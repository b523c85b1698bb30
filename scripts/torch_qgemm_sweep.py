#!/usr/bin/env python3
"""Time variants of ``qgemm``'s two paths (``microflow_tpu_torch/csrc/qgemm.cu``)
at person_detect's shapes (and sine's, for the narrow path), on one CUDA card.

    python3 scripts/torch_qgemm_sweep.py [--variants 2,4,3,1024 ...] [--all-shapes]
    python3 scripts/torch_qgemm_sweep.py --narrow [--variants 16,3,2,3 ...]
                                         [--parent DIR] [--batch 8192]

Tensor-core mode (the default): each variant ``T,MT,B,G`` is the source with
``qgemm_mma``'s constants ``kTiles = T`` (tiles of 8 rows a warp's work
item), ``kMaxTiles = MT`` (m-tiles of 16 output channels a block),
``kMinBlocks = B`` (``__launch_bounds__``' blocks an SM) and ``kMaxBlocks =
G`` (blocks) replaced, timed at person_detect's shapes with K >= 64
(``--all-shapes``: all 14, K <= 32 forced onto the tensor cores too), beside
the ``"dp4a"`` path of the first variant.

Narrow mode (``--narrow``): each variant ``C,R,RW,B`` is the source with
``qgemm_rows``' constants ``kCols = C`` (output columns a lane, so lanes a
row: 1, 2 or 4 at C = 16), ``kRows = R`` and ``kRowsWide = RW`` (rows a
thread per work item at K <= 8 and at 8 < K <= 32) and ``kRowMinBlocks =
B`` (``__launch_bounds__``' blocks an SM; the grid is as many blocks as
the card keeps resident) replaced, timed on the ``"dp4a"``
path at person_detect's four
shapes with K < 64 (batch ``--batch``) and sine's three (batch
``--sine-batch``), beside the ``"mma"`` path of the first variant and,
with ``--parent DIR`` (the root of a checkout of the parent commit, e.g. a
``git archive`` of it), the parent's ``qgemm.cu`` built from that checkout,
on its ``"dp4a"`` path.

All builds run in parallel with ``kernels/build.py``'s flags into
``build/qgemm_sweep/``; ``ptxas`` registers, stack and spills are printed
for each.  At each shape every variant runs on the same random inputs, is
checked bit-equal to ``qgemm_reference``, and is timed on the device
(``chip_smoke.graph_ms``: 20 launches captured in a CUDA graph, replayed
between two CUDA events), in turns and then in reverse order;
``torch._int_mm`` on the same product (``chip_smoke.int_mm_call``) likewise.
Prints one JSON line a shape and, last, the sum over the shapes of each
variant's mean time (person_detect's shapes weighted by their launches a
forward).  Needs CUDA and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
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

from chip_smoke import bound, graph_ms, int_mm_call, nvidia_smi  # noqa: E402
from microflow_tpu_torch.core.activation import FusedActivation, activation_bounds  # noqa: E402
from microflow_tpu_torch.kernels import build  # noqa: E402
from microflow_tpu_torch.kernels.qgemm import qgemm_reference  # noqa: E402

# person_detect's qgemm calls at batch 1: (model, rows per sample, K, N, launches)
PD_SHAPES = [("person_detect", 2304, 8, 16, 1), ("person_detect", 576, 16, 32, 1),
             ("person_detect", 576, 32, 32, 1), ("person_detect", 144, 32, 64, 1),
             ("person_detect", 144, 64, 64, 1), ("person_detect", 36, 64, 128, 1),
             ("person_detect", 36, 128, 128, 5), ("person_detect", 9, 128, 256, 1),
             ("person_detect", 9, 256, 256, 1), ("person_detect", 1, 256, 2, 1)]
# sine's three FC layers, one row a sample
SINE_SHAPES = [("sine", 1, 1, 16, 1), ("sine", 1, 16, 16, 1), ("sine", 1, 16, 1, 1)]
MODES = {
    "mma": {"constants": {"tiles": "kTiles", "max_tiles": "kMaxTiles",
                          "min_blocks": "kMinBlocks", "max_blocks": "kMaxBlocks"},
            "default": ["2,4,3,1024", "2,8,2,1024", "1,8,3,1024", "2,2,4,1024"],
            "kernel": "qgemm_mma", "path": 1},
    "narrow": {"constants": {"cols": "kCols", "rows": "kRows", "rows_wide": "kRowsWide",
                             "min_blocks": "kRowMinBlocks"},
               "default": ["16,3,2,3", "16,2,2,3", "16,4,2,2", "8,3,2,3"],
               "kernel": "qgemm_rows", "path": 0},
}


def variant_source(src: str, constants: dict, values: dict) -> str:
    for key, name in constants.items():
        src, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{values[key]};", src)
        if n != 1:
            raise RuntimeError(f"{name} not found once in qgemm.cu")
    return src


def ptxas_usage(log: str, kernel: str) -> dict:
    """{instantiation: {registers, stack, spill_stores}} of ``kernel``'s
    entry functions in a ``ptxas -v`` log."""
    usage, fn = {}, None
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", ln):
            fn = m.group(1) if kernel in m.group(1) else None
        elif fn and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)):
            usage.setdefault(fn, {}).update(stack=int(m[1]), spill_stores=int(m[2]))
        elif fn and (m := re.search(r"Used (\d+) registers", ln)):
            regs = int(m[1])
            # blocks of 256 threads an SM holds by registers (allocated 8 a
            # thread at a time, 64K an SM, at most 8 blocks)
            usage.setdefault(fn, {}).update(
                registers=regs, blocks_per_sm=min(8, 65536 // (-(-regs // 8) * 8 * 256)))
    return usage


def build_variants(sources: dict, kernel: str) -> dict:
    """name -> (ctypes function, ptxas usage of ``kernel``), from name ->
    (qgemm.cu text, directory holding its headers)."""
    base = os.path.join(ROOT, "build", "qgemm_sweep")
    shutil.rmtree(base, ignore_errors=True)
    procs = {}
    for name, (src, headers) in sources.items():
        d = os.path.join(base, name)
        os.makedirs(d)
        for h in ("epilogue.cuh", "mma_s8.cuh"):
            shutil.copy(os.path.join(headers, h), d)
        with open(os.path.join(d, "qgemm.cu"), "w") as f:
            f.write(src)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
               os.path.join(d, "qgemm.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(os.path.join(base, name, "lib.so"))
        symbol, argtypes = build.SIGNATURES["qgemm"]
        f = getattr(lib, symbol)
        f.argtypes, f.restype = argtypes, ctypes.c_int
        out[name] = (f, ptxas_usage(log, kernel))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--narrow", action="store_true")
    ap.add_argument("--variants", nargs="+")
    ap.add_argument("--parent", help="root of the parent's checkout (narrow mode)")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--sine-batch", type=int, default=1 << 20)
    ap.add_argument("--all-shapes", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_qgemm_sweep: CUDA is not available", file=sys.stderr)
        return 1
    mode = MODES["narrow" if args.narrow else "mma"]
    constants = mode["constants"]
    with open(os.path.join(build.CSRC, "qgemm.cu")) as f:
        src = f.read()
    sources, names = {}, []
    for spec in args.variants or mode["default"]:
        values = dict(zip(constants, (int(v) for v in spec.split(","))))
        name = "_".join(f"{k}{v}" for k, v in values.items())
        sources[name] = (variant_source(src, constants, values), build.CSRC)
        names.append(name)
    if args.parent:
        csrc = os.path.join(os.path.abspath(args.parent), "microflow_tpu_torch", "csrc")
        with open(os.path.join(csrc, "qgemm.cu")) as f:
            sources["parent"] = (f.read(), csrc)
    libs = build_variants(sources, mode["kernel"])
    smi = nvidia_smi("name,power.limit")
    print(json.dumps({"device": smi, "ptxas": {n: u for n, (_, u) in libs.items()}}), flush=True)
    if args.narrow:
        shapes = [s for s in PD_SHAPES if s[2] < 64] + SINE_SHAPES
    else:
        shapes = [s for s in PD_SHAPES if s[2] >= 64 or args.all_shapes]
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    totals = {n: 0.0 for n in list(libs) + ["other_path", "int_mm", "bound"]}
    for model, rows, K, N, launches in shapes:
        M = rows * (args.batch if model == "person_detect" else args.sine_batch)
        t = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(dev)
        x = t(rng.integers(-128, 128, (M, K)), np.int8)
        w = t(rng.integers(-128, 128, (K, N)), np.int8)
        wzp, d = t(np.zeros(N), np.int32), t(rng.integers(-5000, 5000, N), np.int32)
        b0, c1 = t(rng.normal(0, 20, N), np.float32), t(rng.uniform(1e-4, 1e-3, N), np.float32)
        kw = dict(activation=FusedActivation.RELU6, out_scale=0.05, out_zp=-3)
        lo, hi = activation_bounds(**kw)
        ref = qgemm_reference(x, w, wzp, d, b0, c1, **kw)
        out = torch.empty_like(ref)

        def call(f, path):
            return lambda: build.check(
                f(x.data_ptr(), w.data_ptr(), wzp.data_ptr(), d.data_ptr(), b0.data_ptr(),
                  c1.data_ptr(), out.data_ptr(), M, K, N, float(lo), float(hi),
                  int(K % 4 == 0), int(N % 4 == 0), path,
                  torch.cuda.current_stream().cuda_stream), "qgemm")

        fns = {n: call(libs[n][0], 0 if n == "parent" else mode["path"]) for n in libs}
        fns["other_path"] = call(libs[names[0]][0], 1 - mode["path"])
        row = {"model": model, "M": M, "K": K, "N": N, "launches": launches,
               "other_path": "mma" if args.narrow else "dp4a",
               "bound_ms": bound("qgemm", (x, w, wzp, d, b0, c1), kw, ref)[0],
               "int_mm_ms": graph_ms(int_mm_call((x, w))), "ms": {}, "equal": {}}
        for name, fn in fns.items():
            out.zero_()
            fn()
            row["equal"][name] = bool(torch.equal(out, ref))
        order = list(fns)
        for name in order + order[::-1]:
            row["ms"].setdefault(name, []).append(graph_ms(fns[name]))
        weight = launches if model == "person_detect" else 0
        for name, ms in row["ms"].items():
            totals[name] += weight * sum(ms) / len(ms)
        totals["int_mm"] += weight * row["int_mm_ms"]
        totals["bound"] += weight * row["bound_ms"]
        print(json.dumps(row), flush=True)
        if not all(row["equal"].values()):
            raise AssertionError(f"a variant differs from qgemm_reference: {row['equal']}")
        del x, w, ref, out
        torch.cuda.empty_cache()
    print(json.dumps({"person_detect_sum_ms": totals, "batch": args.batch, "device": smi}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
