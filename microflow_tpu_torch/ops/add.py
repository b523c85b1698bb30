"""Quantized elementwise ADD of two int8 tensors of one shape, as TFLite's
``reference/integer_ops/add.h`` computes it (MicroFlow has no ADD).  Every
step is integer arithmetic on int64 tensors, each value inside int32 as in
TFLite:

    a = (x1 - in1_zp) * 2**left_shift               (b from x2 alike)
    s = scale(a, m1, e1) + scale(b, m2, e2)
    y = clamp(scale(s, mo, eo) + out_zp, act_min, act_max)

``scale(v, m, e)`` is ``RoundingDivideByPOT(SaturatingRoundingDoublingHighMul
(v, m), -e)`` (gemmlowp): the product's high word, rounded half away from
zero, then a right shift rounded half away from zero.  The constants are
``AddLayer``'s (``compiler/folding.py::preprocess_add``).
"""

from __future__ import annotations

import torch


def high_mul(v: torch.Tensor, m: int) -> torch.Tensor:
    """gemmlowp's ``SaturatingRoundingDoublingHighMul(v, m)`` of int32
    values held in int64: ``(v*m + nudge) / 2**31``, the division
    truncating toward zero (C++'s).  ``m`` is positive, so it never
    saturates."""
    ab = v * m
    nudge = torch.where(ab >= 0, 1 << 30, 1 - (1 << 30))
    return torch.div(ab + nudge, 1 << 31, rounding_mode="trunc")


def rounding_shift(v: torch.Tensor, exponent: int) -> torch.Tensor:
    """gemmlowp's ``RoundingDivideByPOT(v, exponent)``: an arithmetic right
    shift, plus one where the remainder passes half (half away from
    zero)."""
    if exponent == 0:
        return v
    mask = (1 << exponent) - 1
    threshold = (mask >> 1) + (v < 0).to(v.dtype)
    return (v >> exponent) + ((v & mask) > threshold).to(v.dtype)


def scale(v: torch.Tensor, multiplier: int, shift: int) -> torch.Tensor:
    """``MultiplyByQuantizedMultiplierSmallerThanOneExp(v, multiplier, shift)``."""
    return rounding_shift(high_mul(v, multiplier), -shift)


def add(x1: torch.Tensor, x2: torch.Tensor, layer) -> torch.Tensor:
    """int8 ``x1 + x2`` (one shape) with ``layer``'s folded constants
    (an ``AddLayer``); int8 out."""
    if x1.shape != x2.shape:
        raise ValueError(f"add: shapes {tuple(x1.shape)} and {tuple(x2.shape)} differ")
    a = (x1.to(torch.int64) - layer.in1_q.zp0) * (1 << layer.left_shift)
    b = (x2.to(torch.int64) - layer.in2_q.zp0) * (1 << layer.left_shift)
    s = (scale(a, layer.in1_multiplier, layer.in1_shift)
         + scale(b, layer.in2_multiplier, layer.in2_shift))
    y = scale(s, layer.out_multiplier, layer.out_shift) + layer.out_q.zp0
    return torch.clamp(y, layer.act_min, layer.act_max).to(torch.int8)
