"""Quantized DepthwiseConv2D (reference R8, ``src/ops/depthwise_conv_2d.rs``).

Same padding algebra as Conv2D, but output channel c multiplies view
channel c with weight channel c.  The reference's channel fallback
``v.get(c).unwrap_or(v[0])`` (``src/ops/depthwise_conv_2d.rs:103``) means
that if the input has fewer channels than the weights (the
depth-multiplier stem: input C=1, weights C=8), out-of-range channels read
input channel 0.

The accumulator is a sum of KH*KW shifted int32 products, exact.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.activation import FusedActivation, apply_fused_activation
from ..core.numerics import const_f32, const_int, f32, round_away, saturating_cast
from ..core.tensor import ViewGeometry, pad_nhwc


def window_sum(xp: torch.Tensor, w: torch.Tensor | None, geom: ViewGeometry) -> torch.Tensor:
    """``sum_mn xp[:, sr*i+m, sc*j+n, :] * w[m, n, :]`` in int32 over an
    already padded [B, HP, WP, C'] input; ``w`` is [KH, KW, C] int32 or
    None for a plain window sum.  A C'=1 input broadcasts over C."""
    acc = None
    for m in range(geom.k_rows):
        for n in range(geom.k_cols):
            xs = xp[
                :,
                m : m + geom.stride_rows * (geom.out_rows - 1) + 1 : geom.stride_rows,
                n : n + geom.stride_cols * (geom.out_cols - 1) + 1 : geom.stride_cols,
                :,
            ].to(torch.int32)
            term = xs if w is None else xs * w[m, n]
            acc = term if acc is None else acc + term
    return acc


def depthwise_conv_2d_accumulate(
    x: torch.Tensor, weights: torch.Tensor, geom: ViewGeometry, in_zp: int, w_zp
) -> torch.Tensor:
    """Exact i32 ``q[b,i,j,c] = sum_mn (x[..,c]-in_zp)(w[m,n,c]-w_zp[c])``
    over the zp-padded window."""
    wzp = const_int(np.asarray(w_zp, np.int32), x.device)
    wc = weights.to(device=x.device, dtype=torch.int32) - wzp[None, None, :]
    xc = pad_nhwc(x, geom, in_zp).to(torch.int32) - int(in_zp)
    return window_sum(xc, wc, geom)


def depthwise_conv_2d(
    x: torch.Tensor,  # [B, H, W, IN_C] quantized ints
    weights: torch.Tensor,  # [KH, KW, CH] quantized ints (tflite [1,KH,KW,CH] squeezed)
    *,
    geom: ViewGeometry,
    in_zp: int,
    w_zp,  # i32 [CH] per-channel zero points
    bias0,  # f32 [CH] = f32(out_zp) + C0
    c1,  # f32 [CH]
    out_scale: float,
    out_zp: int,
    activation: FusedActivation,
) -> torch.Tensor:
    out_dtype = x.dtype
    ch = weights.shape[2]
    in_c = x.shape[-1]
    if in_c not in (1, ch):
        # reference channel fallback: channel c of the view, or channel 0
        # if the input has fewer channels than the weights
        chan_idx = const_int([c if c < in_c else 0 for c in range(ch)], x.device)
        x = x[..., chan_idx]
    # in_c == 1 < ch is the depth-multiplier stem: every output channel
    # reads input channel 0, which broadcasts over the CH weight channels
    # in the tap products instead of being copied CH times
    q = depthwise_conv_2d_accumulate(x, weights, geom, in_zp, w_zp)
    y = round_away(const_f32(bias0, x.device) + const_f32(c1, x.device) * f32(q))
    y = saturating_cast(y, out_dtype)
    return apply_fused_activation(y, activation, out_scale, out_zp)
