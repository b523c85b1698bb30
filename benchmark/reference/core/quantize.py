"""Affine quantization core (reference R2, ``src/quantize.rs``).

A quantized tensor is a plain torch integer tensor plus static parameters
(scale / zero-point) kept as host numpy values, as in
``microflow_tpu.core.quantize``.
"""

from __future__ import annotations

import torch

from .numerics import const_f32, f32, round_away, saturating_cast


def quantize(x: torch.Tensor, scale, zero_point, dtype=torch.int8) -> torch.Tensor:
    """``quantize(f) = roundf(f / scale + zp)`` with a saturating cast
    (reference ``src/quantize.rs:26-28``)."""
    y = round_away(f32(x) / const_f32(scale, x.device) + const_f32(zero_point, x.device))
    return saturating_cast(y, dtype)


def dequantize(q: torch.Tensor, scale, zero_point) -> torch.Tensor:
    """``dequantize(q) = scale * (f32(q) - f32(zp))`` (reference
    ``src/quantize.rs:37-39``), in that association."""
    return const_f32(scale, q.device) * (f32(q) - const_f32(zero_point, q.device))
