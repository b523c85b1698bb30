"""Quantized Conv2D (reference R7, ``src/ops/conv_2d.rs``).

The reference extracts a zero-filled view per output pixel and assembles
four terms whose exact integer sum is

    q[f] = sum_over_valid (in - in_zp) * (w[f] - w_zp[f])

(see ``core/tensor.py`` for the algebra).  Padding the input with
``in_zp`` makes it a full-window sum, computed here as im2col (a reshape
for 1x1 stride-1 convs) and one float64 matrix product, exact while
|q| < 2**53.  Requantization per filter f:

    y = roundf(bias0[f] + C1[f] * f32(q[f]))       (f32 mul, then add)
"""

from __future__ import annotations

import torch

from ..core.activation import FusedActivation, apply_fused_activation
from ..core.numerics import const_f32, const_int, f32, round_away, saturating_cast
from ..core.tensor import ViewGeometry, extract_patches


def im2col(x: torch.Tensor, geom: ViewGeometry, pad_value: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*OH*OW, KH*KW*C] rows in (kh, kw, c) order; a
    plain reshape when the window is 1x1 with stride 1."""
    if geom.is_pointwise():
        return x.reshape(-1, x.shape[-1])
    patches = extract_patches(x, geom, pad_value)  # [B, OH, OW, KH, KW, C]
    return patches.reshape(-1, geom.k_rows * geom.k_cols * x.shape[-1])


def conv_2d_accumulate(
    x: torch.Tensor, filters: torch.Tensor, geom: ViewGeometry, in_zp: int, w_zp
) -> torch.Tensor:
    """Exact accumulator ``q[b,i,j,f] = sum (x - in_zp)(w[f] - w_zp[f])``
    over the zp-padded window, float64 [B, OH, OW, F]."""
    nf = filters.shape[0]
    cols = im2col(x, geom, in_zp).to(torch.float64) - float(in_zp)
    wzp = const_int(w_zp, x.device).to(torch.float64)
    wc = filters.to(device=x.device, dtype=torch.float64).reshape(nf, -1) - wzp[:, None]
    q = cols @ wc.T  # [B*OH*OW, F]
    return q.reshape(x.shape[0], geom.out_rows, geom.out_cols, nf)


def conv_2d(
    x: torch.Tensor,  # [B, H, W, C] quantized ints
    filters: torch.Tensor,  # [F, KH, KW, C] quantized ints (tflite OHWI layout)
    *,
    geom: ViewGeometry,
    in_zp: int,
    w_zp,  # i32 [F] per-filter zero points (broadcast from quants)
    bias0,  # f32 [F] = f32(out_zp) + C0
    c1,  # f32 [F] = C1[f] if per-channel else C1[0] broadcast
    out_scale: float,
    out_zp: int,
    activation: FusedActivation,
) -> torch.Tensor:
    out_dtype = x.dtype
    q = conv_2d_accumulate(x, filters, geom, in_zp, w_zp)
    y = round_away(const_f32(bias0, x.device) + const_f32(c1, x.device) * f32(q))
    y = saturating_cast(y, out_dtype)
    return apply_fused_activation(y, activation, out_scale, out_zp)
