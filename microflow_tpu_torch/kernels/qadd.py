"""Quantized elementwise ADD of two int8 tensors (CUDA, ``csrc/qadd.cu``).

The residual join of an inverted-residual block: TFLite's integer ``ADD``
with an ``AddLayer``'s folded constants (``ops/add.py`` has the formula).
The JAX package has no such kernel; the port's per-op path (``"pallas"``)
launches this one for every ``ADD`` of a graph with wiring.  CUDA tensors
launch the kernel, CPU tensors run ``qadd_reference``.
"""

from __future__ import annotations

import torch

from ..ops.add import add
from . import LAUNCHES, build


def qadd_reference(x1: torch.Tensor, x2: torch.Tensor, layer) -> torch.Tensor:
    """The plain torch version of the kernel (``ops.add.add``)."""
    return add(x1, x2, layer)


def qadd(x1: torch.Tensor, x2: torch.Tensor, layer) -> torch.Tensor:
    """int8 ``x1 + x2`` of one shape under ``layer`` (an ``AddLayer``)."""
    if x1.device.type == "cpu":
        return qadd_reference(x1, x2, layer)
    if x1.device.type != "cuda":
        raise ValueError(f"qadd: unsupported device {x1.device}")
    for t, what in ((x1, "x1"), (x2, "x2")):
        if t.dtype != torch.int8 or t.device != x1.device or t.shape != x1.shape:
            raise ValueError(
                f"qadd: {what} must be int8 {tuple(x1.shape)} on {x1.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    x1, x2 = x1.contiguous(), x2.contiguous()
    out = torch.empty_like(x1)
    n = x1.numel()
    if n == 0:
        return out
    vec = int(all(t.data_ptr() % 16 == 0 for t in (x1, x2, out)))
    fn = build.library("qadd").mf_qadd
    rc = build.launch(fn, x1.device, x1.data_ptr(), x2.data_ptr(), out.data_ptr(), n,
                      layer.in1_q.zp0, layer.in2_q.zp0, layer.out_q.zp0, layer.left_shift,
                      layer.in1_multiplier, layer.in1_shift, layer.in2_multiplier,
                      layer.in2_shift, layer.out_multiplier, layer.out_shift, layer.act_min,
                      layer.act_max, vec)
    build.check(rc, "qadd")
    LAUNCHES["qadd"] += 1
    return out
