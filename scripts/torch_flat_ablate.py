#!/usr/bin/env python3
"""What each part of the flat kernel's tensor-core 1x1 op and of its 3x3
depthwise ops costs on one CUDA card (an H100): ``op_pw_mma``, ``op_dw3``
and ``op_dw3_stem`` in ``microflow_tpu_torch/csrc/flatpack.cu``.

    python3 scripts/torch_flat_ablate.py [--variants base,no_mma] [--batch 8192]
                                         [--iters 10]

Each variant is ``csrc/flatpack.cu`` with text substitutions that remove a
part of one op (so its outputs are wrong on purpose and only its time means
anything) or change a constant of its design.  Every variant is built with
the port's ``nvcc`` flags into ``build/torch_ablate/``, all builds in
parallel, then loaded in place of the kernel and timed on every prefix of
person_detect's flat plan as ``scripts/torch_flat_layers.py`` does.
Prints one JSON line: per variant ``ptxas``'s registers and spills, the
whole forward, and the 1x1 class and the depthwise class with each op's
marginal time (ms, CUDA events).  Needs CUDA and ``nvcc``; fails without
them.

Variants of the 1x1 op: ``base`` (the source as it is), ``no_epilogue``
(the raw accumulator's low byte stored, no requantization), ``no_kloop``
(no k-loop: no A or B loads and no MMA), ``no_mma`` (the MMA replaced by
four integer adds), ``no_a_loads`` (A fragments made from registers),
``no_b_loads`` (B words made from registers), ``nt2``/``nt4`` (2 or 4 pixel
tiles a work item instead of 3), ``occupancy3`` (``__launch_bounds__``
minimum 3 blocks an SM instead of 4).  Of the depthwise ops:
``dw_no_epilogue`` (the raw accumulators' low bytes stored),
``dw_no_loads`` (input words made from their offsets, no shared-memory
read), ``dw_no_dp4a`` (each ``__dp4a`` replaced by an xor and an add),
``dw_strip1``/``dw_strip5`` (1 or 5 output pixels a work item of
``op_dw3`` instead of 3).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_flat_layers as tfl  # noqa: E402

from microflow_tpu_torch import parse  # noqa: E402
from microflow_tpu_torch.kernels import build  # noqa: E402
from microflow_tpu_torch.models import model_path  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "torch_ablate")
A_PAIR = "const int4 a0 = __ldg(a), a1 = __ldg(a + 32);"
A_ONE = "const int4 a0 = __ldg(a);"
B_PAIR = "row_words<4>(src, off[j], kb + 16 * t, ic, w[j]);"
B_ONE = "row_words<2>(src, off[j], kb + 8 * t, ic, w[j]);"
EPI_G = "dst[p * oc + r0] = rnd(mf_affine(b0g, c1g, acc[j][i]));"
EPI_H = "dst[p * oc + r0 + 8] = rnd(mf_affine(b0h, c1h, acc[j][2 + i]));"
NT3 = "constexpr int NT = 3;"
DW_EPI = "packed |= (uint32_t)(uint8_t)rnd(mf_affine(k.b0[j], k.c1[j], acc[o][j])) << (8 * j);"
DW_LOAD = "*reinterpret_cast<const uint32_t*>(sg + off + i * c)"
STEM_LOAD = "*reinterpret_cast<const uint32_t*>(src + off + 4 * m)"
DW_DOTS = [("__dp4a((int)xw[j], k.w[dh][j], acc[2 * i][j])", "acc[2 * i][j] + ((int)xw[j] ^ k.w[dh][j])"),
           ("__dp4a((int)xw[j], (int)((unsigned)k.w[dh][j] << 8), acc[2 * i + 1][j])",
            "acc[2 * i + 1][j] + ((int)xw[j] ^ (k.w[dh][j] << 8))"),
           ("__dp4a((int)xw[j], k.w[dh][j], acc[i][j])", "acc[i][j] + ((int)xw[j] ^ k.w[dh][j])"),
           ("__dp4a((int)xw[o], k.w[dh][j], acc[o][j])", "acc[o][j] + ((int)xw[o] ^ k.w[dh][j])")]
STRIP3 = "constexpr int DW_STRIP = 3;"


def variants(src: str) -> dict:
    i = src.index('  asm("mma.sync')
    asm = src[i:src.index(");", i) + 2]
    return {
        "base": [],
        "no_epilogue": [(EPI_G, "dst[p * oc + r0] = (int8_t)acc[j][i];"),
                        (EPI_H, "dst[p * oc + r0 + 8] = (int8_t)acc[j][2 + i];")],
        "no_kloop": [("for (int kb = 0; kb < ic; kb += 64) {",
                      "for (int kb = 0; kb < 0; kb += 64) {")],
        "no_mma": [(asm, "d[0] += a.x ^ b0; d[1] += a.y ^ b1; d[2] += a.z + b0; "
                         "d[3] += a.w + b1;")],
        "no_a_loads": [(A_PAIR, "const int4 a0 = make_int4(lane, kb, m, t), "
                                "a1 = make_int4(kb, lane, t, m);"),
                       (A_ONE, "const int4 a0 = make_int4(lane, kb, m, t);")],
        "no_b_loads": [(B_PAIR, "{ w[j][0] = off[j] + kb; w[j][1] = off[j] ^ kb; "
                                "w[j][2] = off[j] - kb; w[j][3] = kb; }"),
                       (B_ONE, "{ w[j][0] = off[j] + kb; w[j][1] = off[j] ^ kb; }")],
        "nt2": [(NT3, "constexpr int NT = 2;")],
        "nt4": [(NT3, "constexpr int NT = 4;")],
        "occupancy3": [("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads, 3)")],
        "dw_no_epilogue": [(DW_EPI, "packed |= (uint32_t)(uint8_t)acc[o][j] << (8 * j);")],
        "dw_no_loads": [(DW_LOAD, "(uint32_t)(off + i * c)"), (STEM_LOAD, "(uint32_t)(off + 4 * m)")],
        "dw_no_dp4a": DW_DOTS,
        "dw_strip1": [(STRIP3, "constexpr int DW_STRIP = 1;")],
        "dw_strip5": [(STRIP3, "constexpr int DW_STRIP = 5;")],
    }


def build_variants(src: str, table: dict, names) -> dict:
    """Write and build every named variant, one ``nvcc`` each, all started
    together.  Returns name -> (library path, ``ptxas`` register and spill
    lines)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in table[name]:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in csrc/flatpack.cu")
            text = text.replace(old, new)
        cu = os.path.join(OUT_DIR, f"flatpack_{name}.cu")
        so = os.path.join(OUT_DIR, f"libflatpack_{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        out[name] = (so, [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln])
    return out


def load(so: str) -> None:
    """Make ``so`` the library that ``FlatKernel`` launches."""
    lib = ctypes.CDLL(so)
    symbol, argtypes = build.SIGNATURES["flatpack"]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    build._LIBS["flatpack"] = lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=None, help="comma-separated; default all")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flat_ablate: CUDA is not available", file=sys.stderr)
        return 1
    with open(os.path.join(build.CSRC, "flatpack.cu")) as f:
        src = f.read()
    table = variants(src)
    names = args.variants.split(",") if args.variants else list(table)
    built = build_variants(src, table, names)
    g = parse(model_path("person_detect"))
    res = {}
    for name in names:
        so, ptxas = built[name]
        load(so)
        ops, first, make, in_shape = tfl.plan_prefixes("flat", g)
        x = torch.from_numpy(np.random.default_rng(0).integers(
            -128, 128, (args.batch, *in_shape), dtype=np.int8)).cuda()
        marginal = {"pw": [], "dw": []}
        prev = 0.0
        for k in range(first, len(ops) + 1):
            fn = make(k)
            ms = tfl.time_ms(lambda: fn(x), args.iters)
            kind = ops[k - 1][1]  # the first prefix holds two depthwise ops
            if kind in marginal:
                marginal[kind].append([ops[k - 1][0], ms - prev])
            prev = ms
        res[name] = {"ptxas": ptxas, "whole_ms": prev,
                     "pw_ms": sum(t for _, t in marginal["pw"]),
                     "dw_ms": sum(t for _, t in marginal["dw"]),
                     "pw_marginal_ms": marginal["pw"], "dw_marginal_ms": marginal["dw"]}
    build._LIBS.pop("flatpack", None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"model": "person_detect", "batch": args.batch, "device": smi,
                      "variants": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
