"""Integer-domain fused activations (reference R5, ``src/activation.rs``).

All activations operate on already-quantized integer tensors, exactly like
the reference applies them *after* the requantizing cast.
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch


class FusedActivation(enum.Enum):
    """Reference ``FusedActivation`` enum (``src/activation.rs:6-13``)."""

    NONE = "none"
    RELU = "relu"
    RELU6 = "relu6"


def round_away_scalar(y) -> float:
    """Host-side ``libm::roundf`` (round half away from zero).

    ``y`` must be a float32-exact value; the +-0.5 tie-break is done in
    f64, where it is exact, so the result matches roundf bit-for-bit.
    """
    y = float(np.float32(y))
    return math.floor(y + 0.5) if y >= 0 else math.ceil(y - 0.5)


def quantize_scalar(value: float, scale: float, zero_point: int, dtype=np.int8) -> int:
    """Host-side scalar quantize used to fold the ReLU6 clamp constant.

    Matches ``quantize(6., scale, zp)`` with roundf + saturating cast.
    """
    y = np.float32(value) / np.float32(scale) + np.float32(zero_point)
    info = np.iinfo(dtype)
    return int(np.clip(round_away_scalar(y), info.min, info.max))


def relu(x: torch.Tensor, zero_point) -> torch.Tensor:
    """Integer ReLU: ``max(x, zp)`` (reference ``src/activation.rs:21-23``)."""
    return torch.clamp(x, min=int(zero_point))


def relu6(x: torch.Tensor, scale, zero_point) -> torch.Tensor:
    """Integer ReLU6: ``min(max(x, zp), quantize(6, scale, zp))``
    (reference ``src/activation.rs:32-34``)."""
    dtype = np.int8 if x.dtype == torch.int8 else np.uint8
    six = quantize_scalar(6.0, scale, zero_point, dtype)
    return torch.clamp(relu(x, zero_point), max=six)


def apply_fused_activation(
    x: torch.Tensor, activation: FusedActivation, scale, zero_point
) -> torch.Tensor:
    """Dispatch table used by every op (reference match arms, e.g.
    ``src/ops/fully_connected.rs:114-119``)."""
    if activation is FusedActivation.NONE:
        return x
    if activation is FusedActivation.RELU:
        return relu(x, zero_point)
    if activation is FusedActivation.RELU6:
        return relu6(x, scale, zero_point)
    raise ValueError(f"unknown activation {activation}")
