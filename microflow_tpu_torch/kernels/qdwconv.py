"""Fused int8 depthwise conv + requantization + activation (CUDA,
``csrc/qdwconv.cu``).

Port of ``microflow_tpu/kernels/qdwconv.py::qdwconv``.  The input arrives
already padded with ``in_zp`` and the weights centred (``w - w_zp[c]``,
i32), so the only correction left is ``d[c] = -in_zp * sum_mn wc[m,n,c]``:

    q[b,i,j,c] = sum_mn xp[b, sr*i+m, sc*j+n, c] * wc[m,n,c] + d[c]
    y = roundf(bias0[c] + c1[c] * f32(q)), clipped to the activation bounds
"""

from __future__ import annotations

import torch

from ..core.activation import FusedActivation, activation_bounds
from ..core.tensor import ViewGeometry, ViewPadding
from . import LAUNCHES, build
from .qgemm import requant_clip


def qdwconv_reference(
    xp: torch.Tensor, wc: torch.Tensor, d: torch.Tensor, bias0: torch.Tensor, c1: torch.Tensor,
    *, kh: int, kw: int, sr: int, sc: int, oh: int, ow: int,
    activation: FusedActivation, out_scale: float, out_zp: int,
) -> torch.Tensor:
    """The plain torch version of the kernel: KH*KW shifted int32
    products, exact."""
    from ..ops.depthwise_conv_2d import window_sum

    geom = ViewGeometry(in_rows=xp.shape[1], in_cols=xp.shape[2], k_rows=kh, k_cols=kw,
                        out_rows=oh, out_cols=ow, stride_rows=sr, stride_cols=sc,
                        padding=ViewPadding.VALID)
    q = window_sum(xp, wc.to(torch.int32), geom) + d.to(torch.int32)
    lo, hi = activation_bounds(activation, out_scale, out_zp)
    return requant_clip(q, bias0.to(torch.float32), c1.to(torch.float32), lo, hi)


def qdwconv(
    xp: torch.Tensor,  # [B, HP, WP, C] int8, already padded with in_zp
    wc: torch.Tensor,  # [KH, KW, C] i32 centred weights (w - w_zp)
    d: torch.Tensor,  # [C] i32 = -in_zp * sum(wc)
    bias0: torch.Tensor,  # [C] f32
    c1: torch.Tensor,  # [C] f32
    *,
    kh: int, kw: int, sr: int, sc: int, oh: int, ow: int,
    activation: FusedActivation,
    out_scale: float,
    out_zp: int,
) -> torch.Tensor:
    """int8 [B, OH, OW, C].  CUDA tensors launch the kernel; CPU tensors
    run ``qdwconv_reference``."""
    if xp.device.type == "cpu":
        return qdwconv_reference(xp, wc, d, bias0, c1, kh=kh, kw=kw, sr=sr, sc=sc, oh=oh, ow=ow,
                                 activation=activation, out_scale=out_scale, out_zp=out_zp)
    if xp.device.type != "cuda":
        raise ValueError(f"qdwconv: unsupported device {xp.device}")
    if xp.dim() != 4 or xp.dtype != torch.int8 or not xp.is_contiguous():
        raise ValueError(f"qdwconv: xp must be contiguous int8 [B,HP,WP,C], got "
                         f"{xp.dtype} {tuple(xp.shape)}")
    B, HP, WP, C = xp.shape
    if sr * (oh - 1) + kh > HP or sc * (ow - 1) + kw > WP:
        raise ValueError(f"qdwconv: windows {kh}x{kw}/({sr},{sc}) x {oh}x{ow} exceed "
                         f"the padded input {HP}x{WP}")
    for t, what, dt, shape in ((wc, "wc", torch.int32, (kh, kw, C)), (d, "d", torch.int32, (C,)),
                               (bias0, "bias0", torch.float32, (C,)),
                               (c1, "c1", torch.float32, (C,))):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != xp.device or not t.is_contiguous():
            raise ValueError(f"qdwconv: {what} must be contiguous {dt} {shape} on {xp.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((B, oh, ow, C), dtype=torch.int8, device=xp.device)
    if B == 0:
        return out
    lo, hi = activation_bounds(activation, out_scale, out_zp)
    fn = build.library("qdwconv").mf_qdwconv
    vec = int(C % 4 == 0 and xp.data_ptr() % 4 == 0 and out.data_ptr() % 4 == 0
              and wc.data_ptr() % 16 == 0)
    with torch.cuda.device(xp.device):
        rc = fn(xp.data_ptr(), wc.data_ptr(), d.data_ptr(), bias0.data_ptr(), c1.data_ptr(),
                out.data_ptr(), B, HP, WP, C, kh, kw, sr, sc, oh, ow, float(lo), float(hi), vec,
                torch.cuda.current_stream().cuda_stream)
    build.check(rc, "qdwconv")
    LAUNCHES["qdwconv"] += 1
    return out
