#!/usr/bin/env python3
"""Time variants of the column-FC kernel (``microflow_tpu_torch/csrc/colfc.cu``)
on sine, on one CUDA card.

    python3 scripts/torch_colfc_sweep.py [--variants 2,4,magic 1,4,cvt ...]
                                         [--extra NAME=PATH ...]
                                         [--batches 1048576 16777216] [--seed 0]

Each variant ``MT,B,E`` is the source with ``kTilesWarp = MT`` (m-tiles of
16 samples a warp's work item) and ``kMinBlocks = B`` (``__launch_bounds__``'
blocks an SM; the grid is as many blocks as the card keeps resident)
replaced, and its epilogue's ``f32(acc)`` formed as ``E``: ``cvt`` (the
shipped form, ``__int2float_rn``: a conversion, as ``mf_exact2``'s chain
has) or ``magic`` (no conversion: the accumulators start at ``d`` plus
the bits of the f32 1.5 * 2**23, which then reads as 1.5 * 2**23 + acc,
exact for |acc| <= 2**22, and one f32 subtraction gives ``f32(acc)``);
or an ablation that breaks the output on purpose, to split
the time: ``noepi`` (each output the accumulator's low byte: no epilogue,
no epilogue constants), ``noload`` (x's bytes made from their addresses,
no load) or ``nostore`` (a store only where a value no output takes is
met).  ``--extra NAME=PATH`` adds a whole other ``colfc.cu`` with the same
entry point, built as it is.  All builds run in parallel with
``kernels/build.py``'s flags into ``build/colfc_sweep/``; ``ptxas``
registers, stack and spills of each are printed.  At each batch every
variant runs through the port's wrapper (``ColKernel``, its library
function swapped) on the same random input, is checked bit-equal to
``colfc_reference`` (an ablation is not), and is timed on the device
(``chip_smoke.graph_ms``: 20 launches captured in a CUDA graph, replayed
between two CUDA events), in turns and then in reverse order.  Prints one
JSON line a batch and, last, each variant's mean device ms a batch.  Needs
CUDA and ``nvcc``.
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

from chip_smoke import graph_ms, max_abs_err, nvidia_smi  # noqa: E402
from microflow_tpu_torch import parse  # noqa: E402
from microflow_tpu_torch.kernels import build, build_col_kernel, colfc_reference  # noqa: E402
from microflow_tpu_torch.models import model_path  # noqa: E402

EPILOGUES = {
    "cvt": None,  # the source as it is
    "magic": (("int acc[4] = {d.x, d.y, d.x, d.y};",
               "int acc[4] = {d.x + 0x4B400000, d.y + 0x4B400000, d.x + 0x4B400000, "
               "d.y + 0x4B400000};"),
              ("{ return __int2float_rn(acc); }",
               "{ return __fsub_rn(__int_as_float(acc), 12582912.0f); }")),
    "noepi": (("  const float y = __fadd_rn(b0, __fmul_rn(c1, acc_f32(acc)));\n"
               "  float t = __fadd_rn(y, copysignf(0.5f, y));\n"
               "  if (kClamp) t = fminf(fmaxf(t, lo), hi);\n"
               "  return __float2int_rz(t);",
               "  return acc;"),),
    "noload": (("__ldg(reinterpret_cast<const uint32_t*>(p))", "(uint32_t)(uintptr_t)p"),
               ("__ldg(p + i)", "(uintptr_t)(p + i)")),
    "nostore": tuple((f"if ({c}) {o}", f"if ({c} && v == 0x7fffffffu) {o}") for c, o in (
        ("c < n_out", "*reinterpret_cast"), ("c < n_out", "o[c]"), ("c + 1 < n_out", "o[c + 1]")))
    + (("const uint32_t v = pack_s8(v1, v0, 0u);",
        "const uint32_t v = pack_s8(v1, v0, 0u);\n      if (v != 0x7fffffffu) continue;"),),
}
ABLATIONS = {"noepi", "noload", "nostore"}


def variant_source(src: str, tiles: int, blocks: int, epilogue: str) -> str:
    for name, value in (("kTilesWarp", tiles), ("kMinBlocks", blocks)):
        src, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", src)
        if n != 1:
            raise RuntimeError(f"{name} not found once in colfc.cu")
    for old, new in EPILOGUES[epilogue] or ():
        if old not in src:
            raise RuntimeError(f"{old!r} not found in colfc.cu")
        src = src.replace(old, new)
    return src


def build_variants(names: list[str], extra: dict) -> dict:
    """name -> (ctypes function, ptxas usage of col_kernel), for the
    variants ``names`` and the sources ``extra`` (name -> path)."""
    with open(os.path.join(build.CSRC, "colfc.cu")) as f:
        src = f.read()
    base = os.path.join(ROOT, "build", "colfc_sweep")
    shutil.rmtree(base, ignore_errors=True)
    procs = {}
    for name in [*names, *extra]:
        d = os.path.join(base, name.replace(",", "_"))
        os.makedirs(d)
        shutil.copy(os.path.join(build.CSRC, "mma_s8.cuh"), d)
        if name in extra:
            shutil.copy(extra[name], os.path.join(d, "colfc.cu"))
        else:
            tiles, blocks, epilogue = name.split(",")
            with open(os.path.join(d, "colfc.cu"), "w") as f:
                f.write(variant_source(src, int(tiles), int(blocks), epilogue))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
               os.path.join(d, "colfc.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), d)
    out = {}
    for name, (proc, d) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        usage = {}
        if m := re.search(r"Used (\d+) registers", log):
            usage["registers"] = int(m[1])
        if m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", log):
            usage.update(stack=int(m[1]), spill_stores=int(m[2]))
        symbol, argtypes = build.SIGNATURES["colfc"]
        fn = getattr(ctypes.CDLL(os.path.join(d, "lib.so")), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        out[name] = (fn, usage)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+",
                    default=["4,3,cvt", "4,3,magic", "6,2,cvt", "8,2,cvt", "4,4,cvt"])
    ap.add_argument("--extra", nargs="*", default=[])
    ap.add_argument("--batches", nargs="+", type=int, default=[1 << 20, 1 << 24])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_colfc_sweep: CUDA is not available", file=sys.stderr)
        return 1
    smi = nvidia_smi("name,power.limit")
    extra = dict(e.split("=", 1) for e in args.extra)
    libs = build_variants(args.variants, extra)
    names = [*args.variants, *extra]
    print(json.dumps({"device": smi, "ptxas": {n: u for n, (_, u) in libs.items()}}), flush=True)
    dev = torch.device("cuda")
    col, meta = build_col_kernel(parse(model_path("sine")), device=dev)
    rng = np.random.default_rng(args.seed)
    totals = {n: 0.0 for n in names}
    for b in args.batches:
        x = torch.from_numpy(rng.integers(-128, 128, (b, meta["k0"]), dtype=np.int8)).to(dev)
        want = colfc_reference(col.plan, x)
        row = {n: {"device_ms": []} for n in names}
        for order in (names, names[::-1]):
            for n in order:
                col._fn = libs[n][0]
                row[n]["max_abs_err"] = max_abs_err(col(x), want)
                row[n]["device_ms"].append(graph_ms(lambda: col(x)))
        for n in names:
            row[n]["ablation"] = n.split(",")[-1] in ABLATIONS
            totals[n] += sum(row[n]["device_ms"]) / 2
        print(json.dumps({"batch": b, "device": smi, **row}), flush=True)
        bad = [n for n in names if row[n]["max_abs_err"] and not row[n]["ablation"]]
        if bad:
            raise AssertionError(f"variants {bad} differ from colfc_reference at batch {b}")
        del x, want
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "mean_device_ms_summed_over_batches": totals}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
