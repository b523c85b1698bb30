"""Quantized softmax over int8 rows (CUDA, ``csrc/qsoftmax.cu``): the
per-op path's softmax on the card, one launch a call.

The plain op (``ops/softmax.py``) sums each row left to right, as the
reference and the whole-network kernels do, which in plain torch is one
launch a column: 1001 a call for MobileNetV2's classes.  The kernel keeps
that order, one thread a row.  CUDA tensors launch it, CPU tensors run
``qsoftmax_reference``.
"""

from __future__ import annotations

import torch

from ..ops.softmax import softmax
from . import LAUNCHES, build


def qsoftmax_reference(x: torch.Tensor, *, in_scale: float, out_scale: float,
                       out_zp: int) -> torch.Tensor:
    """The plain torch version of the kernel (``ops.softmax.softmax``)."""
    return softmax(x, in_scale=in_scale, out_scale=out_scale, out_zp=out_zp)


def qsoftmax(x: torch.Tensor, *, in_scale: float, out_scale: float, out_zp: int) -> torch.Tensor:
    """int8 [M, N] -> int8 [M, N]."""
    if x.device.type == "cpu":
        return qsoftmax_reference(x, in_scale=in_scale, out_scale=out_scale, out_zp=out_zp)
    if x.device.type != "cuda" or x.dtype != torch.int8 or x.dim() != 2:
        raise ValueError(f"qsoftmax: x must be int8 [M, N] on CUDA, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    M, N = x.shape
    if M == 0:
        return out
    fn = build.library("qsoftmax").mf_qsoftmax
    rc = build.launch(fn, x.device, x.data_ptr(), out.data_ptr(), M, N, float(in_scale),
                      float(out_scale), int(out_zp))
    build.check(rc, "qsoftmax")
    LAUNCHES["qsoftmax"] += 1
    return out
