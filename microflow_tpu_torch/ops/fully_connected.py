"""Quantized FullyConnected (reference R6, ``src/ops/fully_connected.rs``).

Per output element (i, j), as ``microflow_tpu.ops.fully_connected``:

    acc    = sum_k in[i,k] * w[k,j]
    q      = acc - rowsum(in)[i] * w_zp - C2[j] + C3         (exact integer)
    y      = roundf(bias0[j] + C1 * f32(q))                  (f32 mul, then add)
    out    = saturating_cast(y) |> fused activation

The contraction runs in float64, which is exact while |acc| < 2**53 (the
largest here is 128*128*4000 < 2**26): PyTorch has no int32 matmul on
CUDA, and float32 or TF32 would round.  The epilogue is two separate f32
ops, one rounding each, as the reference computes it; it is never fused
into one multiply-add.
"""

from __future__ import annotations

import torch

from ..core.activation import FusedActivation, apply_fused_activation
from ..core.numerics import as_device, const_f32, f32, round_away, saturating_cast


def fc_partial(x: torch.Tensor, weights: torch.Tensor, *, w_zp: int) -> torch.Tensor:
    """``acc - rowsum(in) * w_zp`` over the columns of ``x`` [B, K] and the
    rows of ``weights`` [K, N], float64 [B, N], exact.  Partials over
    disjoint slices of K add up, exactly, to the whole contraction's."""
    x64 = x.to(torch.float64)
    acc = x64 @ weights.to(device=x.device, dtype=torch.float64)  # [B, N], exact
    return acc - x64.sum(dim=1, keepdim=True) * float(w_zp)


def fc_requant(partial: torch.Tensor, *, bias0, c1, c2, c3: int, out_scale: float, out_zp: int,
               activation: FusedActivation, out_dtype: torch.dtype) -> torch.Tensor:
    """``q = partial - C2 + C3``, then the epilogue and the activation."""
    dev = partial.device
    c2 = as_device(c2, dev).to(torch.float64)
    q = partial - c2[None, :] + float(c3)
    y = round_away(const_f32(bias0, dev)[None, :] + const_f32(c1, dev) * f32(q))
    y = saturating_cast(y, out_dtype)
    return apply_fused_activation(y, activation, out_scale, out_zp)


def fully_connected(
    x: torch.Tensor,  # [B, K] quantized ints
    weights: torch.Tensor,  # [K, N] quantized ints
    *,
    w_zp: int,
    bias0,  # f32 [N] = f32(out_zp) + C0   (folded)
    c1,  # f32 scalar
    c2,  # i32 [N]
    c3: int,
    out_scale: float,
    out_zp: int,
    activation: FusedActivation,
) -> torch.Tensor:
    return fc_requant(fc_partial(x, weights, w_zp=w_zp), bias0=bias0, c1=c1, c2=c2, c3=c3,
                      out_scale=out_scale, out_zp=out_zp, activation=activation,
                      out_dtype=x.dtype)
