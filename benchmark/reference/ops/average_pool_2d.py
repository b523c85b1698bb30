"""Quantized AveragePool2D (reference R9, ``src/ops/average_pool_2d.rs``).

Per output pixel the reference computes

    x = (1 / len) * f32(sum_over_view)        # f32 reciprocal, then mul
    y = roundf(C0 * x + C1)                   # f32 mul, then add

where the view is ZERO-filled (true 0, not in_zp) and ``len`` counts only
in-bounds elements (``src/ops/average_pool_2d.rs:82-95``).  ``1/len`` is a
static f32 reciprocal plane; the multiply order is the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.activation import FusedActivation, apply_fused_activation
from ..core.numerics import const_f32, f32, round_away, saturating_cast
from ..core.tensor import ViewGeometry, pad_nhwc
from .depthwise_conv_2d import window_sum


def average_pool_2d(
    x: torch.Tensor,  # [B, H, W, C] quantized ints
    *,
    geom: ViewGeometry,
    c0: float,  # f32
    c1: float,  # f32
    out_scale: float,
    out_zp: int,
    activation: FusedActivation,
) -> torch.Tensor:
    out_dtype = x.dtype
    dev = x.device
    s = window_sum(pad_nhwc(x, geom, 0), None, geom)  # [B, OH, OW, C] i32
    recip = (np.float32(1.0) / geom.len_plane().astype(np.float32)).astype(np.float32)
    mean = const_f32(recip, dev)[None, :, :, None] * f32(s)
    y = round_away(const_f32(c0, dev) * mean + const_f32(c1, dev))
    y = saturating_cast(y, out_dtype)
    return apply_fused_activation(y, activation, out_scale, out_zp)
