"""Integer backward functions (reference R13-R15, R17:
``src/gradient_fully_connected.rs``, ``gradient_conv_2d.rs``,
``gradient_depthwise_conv_2d.rs``, ``gradient_average_pool.rs``), as
``microflow_tpu.train.gradients``, on batched tensors: the batch is the
leading axis and every per-sample quantity (the conv norms, the rounding
of each sample's gradient) stays per sample.

Gradients flow between layers as raw i32 quantized-domain deltas.
Activation masking is straight-through: outputs that a fused ReLU/ReLU6
pinned to the rail pass no gradient.

Reference quirks replicated on purpose (cited at each site):

* FC *input* gradients mask on the RAW quantized output (> 0), while
  weight/bias gradients mask on ``output - zero_point``;
* conv gradients are normalized per *sample* by sums of |dOut| (per
  weight-tap for conv, one scalar for depthwise) and rounded before the
  saturating i32 accumulation across the batch (``optimizer``);
* 0/0 normalization produces NaN in Rust, which casts to 0 via ``as``.

Integer arithmetic: the JAX package's i32 dots, einsums and sums wrap.
Here every integer sum is exact (int64, or float64 where it is a
contraction: torch has no integer matmul on CUDA) and is wrapped to i32
once at the end, which gives the same bits (sums modulo 2**32 do not
depend on where the wrap happens).  Sums of f32 values that the JAX
package takes in f32 (the conv norms) are taken exactly and rounded to
f32 once: the same value while their magnitudes stay below 2**24, where
f32 adds of integers are exact in any order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compiler.ir import (
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
)
from ..core.activation import FusedActivation, quantize_scalar
from ..core.numerics import (
    as_device,
    const_f32,
    const_int,
    f32,
    round_away,
    sat_cast_nan0,
    saturating_sub_int,
)
from ..core.tensor import extract_patches, pad_nhwc

# Terms a float64 dot sums exactly: one operand within 2**8 (an int8 or
# uint8 value less its zero point, or a 0/1 mask), the other within 2**31
# (i32): each product is below 2**39, and 2**14 of them below 2**53.
DOT_CHUNK = 1 << 14

_NP_INT = {torch.int8: np.int8, torch.uint8: np.uint8}


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int64 ``a @ b`` (``torch.matmul`` broadcasting) of integer
    tensors, one of them within 2**8 in magnitude and the other within
    i32: float64 matmuls over chunks of ``DOT_CHUNK`` terms, each exact,
    added in int64."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    k = a.shape[-1]
    out = None
    for s in range(0, max(k, 1), DOT_CHUNK):
        part = torch.matmul(a[..., s:s + DOT_CHUNK], b[..., s:s + DOT_CHUNK, :]).to(torch.int64)
        out = part if out is None else out + part
    return out


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """An exact integer -> i32, wrapping as XLA's i32 arithmetic does."""
    return x.to(torch.int64).to(torch.int32)


def exact_f32_sum(x: torch.Tensor, dim) -> torch.Tensor:
    """Sum of f32 values, exact in float64, rounded to f32 once."""
    return x.to(torch.float64).sum(dim).to(torch.float32)


def activity_mask(out_q: torch.Tensor, activation: FusedActivation, out_scale, out_zp, *,
                  raw: bool) -> torch.Tensor:
    """Which outputs pass gradient.  ``raw=True`` replicates the FC
    input-grad quirk (``gradient_fully_connected.rs:171-177``: compares
    the raw quantized output, not output - zp)."""
    if activation is FusedActivation.NONE:
        return torch.ones(out_q.shape, dtype=torch.bool, device=out_q.device)
    val = out_q if raw else saturating_sub_int(out_q, out_zp)
    if activation is FusedActivation.RELU:
        return val > 0
    q6 = quantize_scalar(6.0, out_scale, out_zp, _NP_INT[out_q.dtype])
    return (val > 0) & (val < q6)


def mask_d_out(layer, out_q, d_out, raw: bool = False) -> torch.Tensor:
    mask = activity_mask(out_q, layer.activation, layer.out_q.scale0, layer.out_q.zp0, raw=raw)
    return torch.where(mask, d_out, torch.zeros((), dtype=d_out.dtype, device=d_out.device))


# --- FullyConnected ---------------------------------------------------------


def fc_backward(layer: FullyConnectedLayer, x_q, out_q, weights, d_out):
    """x_q [B,K], out_q/d_out [B,N] -> (dW i32 [K,N] summed over the batch,
    bias_grad f32 [N], dIn i32 [B,K]).

    Reference ``update_grad_fully_connected`` (``gradient_fully_connected.rs:11-61``).
    """
    dW, col_sums = fc_weight_sums(layer, x_q, out_q, d_out)
    return wrap_i32(dW), f32(wrap_i32(col_sums)), fc_input_grad(layer, out_q, weights, d_out)


def fc_weight_sums(layer: FullyConnectedLayer, x_q, out_q, d_out):
    """The exact integer sums under the FC weight and bias gradients, before
    the wrap to i32: (dW int64 [K,N], the masked dOut's column sums int64
    [N]).  Over rows of x_q's columns (a slice of K) and over chunks of the
    batch they add up to the whole: the sharded step sums them so."""
    md_w = mask_d_out(layer, out_q, d_out)
    xc = x_q.to(torch.int32) - layer.in_q.zp0
    return int_dot(xc.T, md_w), md_w.to(torch.int64).sum(0)


def fc_input_grad(layer: FullyConnectedLayer, out_q, weights, d_out):
    """dIn i32 [B,K] of the FC backward (``weights`` [K,N], or a slice of
    its rows for those columns of dIn); it masks on the raw quantized output
    (``gradient_fully_connected.rs:171-177``)."""
    md_in = mask_d_out(layer, out_q, d_out, raw=True)
    wc = weights.to(torch.int32) - layer.w_q.zp0
    return wrap_i32(int_dot(md_in, wc.T))


def fc_backward_float(layer: FullyConnectedLayer, x_q, out_q, weights, d_out_f32):
    """The reference's "unquantized" f32 twins of the FC gradients
    (``gradient_fully_connected.rs:118-152`` weights, ``:198-232`` input,
    ``:268-299`` bias): dequantized-domain gradients with the same
    activation masking.  The two products are f32 matmuls, which sum in
    another order than XLA's.

    Returns (dW f32 [K,N], bias_grad f32 [N], dIn f32 [B,K])."""
    dev = x_q.device
    md_w = mask_d_out(layer, out_q, d_out_f32)
    xd = const_f32(layer.in_q.scale0, dev) * (f32(x_q) - const_f32(layer.in_q.zp0, dev))
    dW = xd.T @ md_w
    # the scale factor is commented out in the reference
    # (gradient_fully_connected.rs:295-297)
    bias_grad = md_w.sum(0)
    # the input grad masks on the RAW quantized output (the integer path's
    # quirk, :171-177 vs :206-212)
    md_in = mask_d_out(layer, out_q, d_out_f32, raw=True)
    wd = const_f32(layer.w_q.scale0, dev) * (f32(weights) - const_f32(layer.w_q.zp0, dev))
    return dW, bias_grad, md_in @ wd.T


# --- windows ----------------------------------------------------------------


def _taps(geom, KH, KW):
    """Per tap (m, n): the strided slices of the padded input that tap
    reads for every output window, and of the scatter frame it writes."""
    sr, sc = geom.stride_rows, geom.stride_cols
    rh, rw = sr * (geom.out_rows - 1) + 1, sc * (geom.out_cols - 1) + 1
    return [(m, n, slice(m, m + rh, sr), slice(n, n + rw, sc))
            for m in range(KH) for n in range(KW)]


def _frame(geom, KH, KW, B, C, device) -> torch.Tensor:
    """The int64 backward scatter frame [B, hp, wp, C]: the padded input,
    or the taps' reach [0, K + s*(O-1)) where that is larger."""
    top, bottom, left, right = geom.pad_amounts()
    hp = max(geom.in_rows + top + bottom, KH + geom.stride_rows * (geom.out_rows - 1))
    wp = max(geom.in_cols + left + right, KW + geom.stride_cols * (geom.out_cols - 1))
    return torch.zeros((B, hp, wp, C), dtype=torch.int64, device=device)


def _crop(geom, frame: torch.Tensor) -> torch.Tensor:
    top, _, left, _ = geom.pad_amounts()
    return frame[:, top:top + geom.in_rows, left:left + geom.in_cols]


def _channels(values, device) -> torch.Tensor:
    """A per-channel integer vector (numpy, or a tensor already on
    ``device``) as int64 on ``device``."""
    t = as_device(values, device) if torch.is_tensor(values) else const_int(values, device)
    return t.to(torch.int64)


def _centred_input(layer, x_q) -> torch.Tensor:
    """The input padded with its zero point, less it, as int64: padded
    positions are exactly 0 (the identity ``extract_patches`` uses)."""
    in_zp = layer.in_q.zp0
    return pad_nhwc(x_q, layer.geom, in_zp).to(torch.int64) - in_zp


# --- Conv2D -----------------------------------------------------------------


def conv_backward_sample(layer: Conv2DLayer, x_q, out_q, weights, d_out, w_zp_vec):
    """Per-sample conv gradients (``gradient_conv_2d.rs``) of a batch.

    x_q [B,H,W,C], out_q/d_out [B,OH,OW,F] -> (dW_q int8 [B,F,KH,KW,C],
    bias_grad f32 [B,F], dIn i32 [B,H,W,C]).  The contractions are one
    batched matmul a tap; bit-equal to :func:`conv_backward_sample_scatter`."""
    md = mask_d_out(layer, out_q, d_out)  # [B, OH, OW, F] i32
    # bias gradient: masked sum / signed total (``gradient_conv_2d.rs:251-301``)
    norm_b = exact_f32_sum(f32(d_out), (1, 2, 3))
    bias_grad = f32(wrap_i32(md.to(torch.int64).sum((1, 2)))) / norm_b[:, None]
    return (conv_weight_grad_sample(layer, x_q, md), bias_grad,
            conv_input_grad(layer, md, weights, w_zp_vec))


def conv_weight_grad_sample(layer: Conv2DLayer, x_q, md) -> torch.Tensor:
    """The weight half of :func:`conv_backward_sample`: x_q [B,H,W,C] and
    the masked dOut ``md`` [B,OH,OW,F] i32 -> dW_q int8 [B,F,KH,KW,C], each
    sample's gradient normalized per tap by its sum of |dOut| where valid,
    rounded and saturated."""
    geom = layer.geom
    F_, KH, KW, C = layer.filters.shape
    B, P = x_q.shape[0], geom.out_rows * geom.out_cols
    md_t = md.reshape(B, P, F_).transpose(1, 2)  # [B, F, P]
    xc = _centred_input(layer, x_q)
    dw_acc = torch.stack([int_dot(md_t, xc[:, rs, cs].reshape(B, P, C))
                          for _, _, rs, cs in _taps(geom, KH, KW)],
                         dim=2).reshape(B, F_, KH, KW, C)
    valid = const_int(geom.valid_mask_plane().reshape(P, KH * KW), x_q.device, torch.int32)
    norm_w = wrap_i32(int_dot(md_t.abs(), valid)).reshape(B, F_, KH, KW)
    return sat_cast_nan0(round_away(f32(wrap_i32(dw_acc)) / f32(norm_w)[..., None]), torch.int8)


def conv_input_grad(layer: Conv2DLayer, md, weights, w_zp_vec) -> torch.Tensor:
    """The input half of :func:`conv_backward_sample`: dIn i32 [B,H,W,C]
    from the masked dOut ``md`` [B,OH,OW,F] i32, the transpose of the
    forward taps, normalized per element by the same scatter of |dOut|."""
    geom = layer.geom
    F_, KH, KW, C = layer.filters.shape
    B, dev = md.shape[0], md.device
    wc = weights.to(torch.int64) - _channels(w_zp_vec, dev)[:, None, None, None]
    md_p = md.reshape(B, geom.out_rows * geom.out_cols, F_)
    amd_f = md.abs().to(torch.int64).sum(-1, keepdim=True)
    d_inp = _frame(geom, KH, KW, B, C, dev)
    n_inp = _frame(geom, KH, KW, B, 1, dev)
    for m, n, rs, cs in _taps(geom, KH, KW):
        d_inp[:, rs, cs] += int_dot(md_p, wc[:, m, n, :]).reshape(
            B, geom.out_rows, geom.out_cols, C)
        n_inp[:, rs, cs] += amd_f
    d_in = round_away(f32(wrap_i32(_crop(geom, d_inp))) / f32(wrap_i32(_crop(geom, n_inp))))
    return sat_cast_nan0(d_in, torch.int32)


def conv_backward_sample_scatter(layer: Conv2DLayer, x_q, out_q, weights, d_out, w_zp_vec):
    """The direct transcription of ``gradient_conv_2d.rs`` (patch-tensor
    products and a strided add a tap, all in int64): the oracle that
    :func:`conv_backward_sample` is held to."""
    geom = layer.geom
    in_zp = layer.in_q.zp0
    F_, KH, KW, C = layer.filters.shape
    B, dev = x_q.shape[0], x_q.device
    md = mask_d_out(layer, out_q, d_out).to(torch.int64)  # [B, OH, OW, F]
    amd = mask_d_out(layer, out_q, d_out).abs().to(torch.int64)

    patches = extract_patches(x_q, geom, pad_value=in_zp)  # [B,OH,OW,KH,KW,C]
    centered = patches.to(torch.int64) - in_zp
    dw_acc = (centered[:, :, :, None] * md[..., None, None, None]).sum((1, 2))  # [B,F,KH,KW,C]
    valid = const_int(geom.valid_mask_plane(), dev, torch.int64)
    norm_w = (valid[None, :, :, None] * amd[..., None, None]).sum((1, 2))  # [B,F,KH,KW]
    dw_q = sat_cast_nan0(round_away(f32(wrap_i32(dw_acc)) / f32(wrap_i32(norm_w))[..., None]),
                         torch.int8)

    norm_b = exact_f32_sum(f32(d_out), (1, 2, 3))
    bias_grad = f32(wrap_i32(md.sum((1, 2)))) / norm_b[:, None]

    wc = weights.to(torch.int64) - _channels(w_zp_vec, dev)[:, None, None, None]
    d_inp = _frame(geom, KH, KW, B, C, dev)
    n_inp = _frame(geom, KH, KW, B, 1, dev)
    amd_f = amd.sum(-1, keepdim=True)
    for m, n, rs, cs in _taps(geom, KH, KW):
        d_inp[:, rs, cs] += (md[..., None] * wc[:, m, n, :]).sum(-2)
        n_inp[:, rs, cs] += amd_f
    d_in = round_away(f32(wrap_i32(_crop(geom, d_inp))) / f32(wrap_i32(_crop(geom, n_inp))))
    return dw_q, bias_grad, sat_cast_nan0(d_in, torch.int32)


# --- DepthwiseConv2D --------------------------------------------------------


def _dw_check(layer: DepthwiseConv2DLayer, x_q) -> None:
    if x_q.shape[-1] != layer.weights.shape[2]:
        raise NotImplementedError(
            "depthwise training with depth multiplier != 1 (reference panics here too)")


def dwconv_backward_sample(layer: DepthwiseConv2DLayer, x_q, out_q, weights, d_out, w_zp_vec):
    """Per-sample depthwise gradients (``gradient_depthwise_conv_2d.rs``)
    of a batch: x_q [B,H,W,CH], out_q/d_out [B,OH,OW,CH] -> (dW_q int8
    [B,KH,KW,CH], bias_grad f32 [B,CH], dIn i32 [B,H,W,CH]).  Elementwise
    int64 products a tap; bit-equal to :func:`dwconv_backward_sample_scatter`.

    Requires IN_C == CH (the reference's gradient code indexes out of
    bounds for the depth-multiplier case and is never exercised there)."""
    _dw_check(layer, x_q)
    geom = layer.geom
    KH, KW, CH = layer.weights.shape
    B, dev = x_q.shape[0], x_q.device
    # one scalar norm a sample, over ALL |dOut|, unmasked (lines 103-109/190-196)
    norm = exact_f32_sum(torch.abs(f32(d_out)), (1, 2, 3))[:, None, None, None]
    md = mask_d_out(layer, out_q, d_out).to(torch.int64)  # [B, OH, OW, CH]

    xc = _centred_input(layer, x_q)
    taps = _taps(geom, KH, KW)
    dw_acc = torch.stack([(xc[:, rs, cs] * md).sum((1, 2)) for _, _, rs, cs in taps],
                         dim=1).reshape(B, KH, KW, CH)
    dw_q = sat_cast_nan0(round_away(f32(wrap_i32(dw_acc)) / norm), torch.int8)

    # bias: saturating per-pixel adds in the reference; a plain sum here,
    # as in the JAX package
    bias_grad = f32(wrap_i32(md.sum((1, 2))))

    wc = weights.to(torch.int64) - _channels(w_zp_vec, dev)
    d_inp = _frame(geom, KH, KW, B, CH, dev)
    for m, n, rs, cs in taps:
        d_inp[:, rs, cs] += md * wc[m, n]
    d_in = round_away(f32(wrap_i32(_crop(geom, d_inp))) / norm)
    return dw_q, bias_grad, sat_cast_nan0(d_in, torch.int32)


def dwconv_backward_sample_scatter(layer: DepthwiseConv2DLayer, x_q, out_q, weights, d_out,
                                   w_zp_vec):
    """Direct transcription oracle for :func:`dwconv_backward_sample`
    (patch tensor and a strided add a tap)."""
    _dw_check(layer, x_q)
    geom = layer.geom
    in_zp = layer.in_q.zp0
    KH, KW, CH = layer.weights.shape
    B, dev = x_q.shape[0], x_q.device
    norm = exact_f32_sum(torch.abs(f32(d_out)), (1, 2, 3))[:, None, None, None]
    md = mask_d_out(layer, out_q, d_out).to(torch.int64)

    patches = extract_patches(x_q, geom, pad_value=in_zp)  # [B,OH,OW,KH,KW,CH]
    centered = patches.to(torch.int64) - in_zp
    dw_acc = (centered * md[:, :, :, None, None, :]).sum((1, 2))  # [B,KH,KW,CH]
    dw_q = sat_cast_nan0(round_away(f32(wrap_i32(dw_acc)) / norm), torch.int8)
    bias_grad = f32(wrap_i32(md.sum((1, 2))))

    wc = weights.to(torch.int64) - _channels(w_zp_vec, dev)
    d_inp = _frame(geom, KH, KW, B, CH, dev)
    sr, sc = geom.stride_rows, geom.stride_cols
    oh, ow = geom.out_rows, geom.out_cols
    for m in range(KH):
        for n in range(KW):
            d_inp[:, m:m + sr * oh:sr, n:n + sc * ow:sc] += md * wc[m, n]
    d_in = round_away(f32(wrap_i32(_crop(geom, d_inp))) / norm)
    return dw_q, bias_grad, sat_cast_nan0(d_in, torch.int32)


# --- AveragePool2D ----------------------------------------------------------


def avgpool_backward_sample(layer: AveragePool2DLayer, out_q, d_out):
    """dOut added to every input position of its window
    (``gradient_average_pool.rs:10-73``): out_q/d_out [B,OH,OW,C] -> dIn
    i32 [B,H,W,C]."""
    geom = layer.geom
    md = mask_d_out(layer, out_q, d_out).to(torch.int64)
    d_inp = _frame(geom, geom.k_rows, geom.k_cols, md.shape[0], md.shape[-1], md.device)
    for _, _, rs, cs in _taps(geom, geom.k_rows, geom.k_cols):
        d_inp[:, rs, cs] += md
    return wrap_i32(_crop(geom, d_inp))
