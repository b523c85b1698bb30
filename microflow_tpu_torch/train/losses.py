"""Losses and initial backward gradients (reference R16 part,
``src/update_layer.rs:296-345``), as ``microflow_tpu.train.losses``.

Gradients are integer (i32) differences of quantized buffers: the
reference backpropagates raw quantized-domain deltas, not float grads.
"""

from __future__ import annotations

import torch

from ..core.numerics import const_f32, f32
from ..ops.softmax import softmax


def mse_loss(pred_q: torch.Tensor, gt_q: torch.Tensor, scale: float) -> torch.Tensor:
    """``0.5 * sum((scale * (pred - gt))^2)`` (``update_layer.rs:296-306``)."""
    diff = const_f32(scale, pred_q.device) * (f32(pred_q) - f32(gt_q))
    return const_f32(0.5, pred_q.device) * torch.sum(diff * diff)


def mse_grad(pred_q: torch.Tensor, gt_q: torch.Tensor) -> torch.Tensor:
    """i32 ``pred - gt`` (``update_layer.rs:308-315``)."""
    return pred_q.to(torch.int32) - gt_q.to(torch.int32)


def crossentropy_grad(logits_q: torch.Tensor, out_scale: float, out_zp: int,
                      label_q: torch.Tensor, in_scale: float) -> torch.Tensor:
    """``softmax(pred) - label`` in the quantized domain, i32
    (``update_layer.rs:316-333``).  ``in_scale`` is the logits' scale
    (softmax dequantizes with it)."""
    sm = softmax(logits_q, in_scale=in_scale, out_scale=out_scale, out_zp=out_zp)
    return sm.to(torch.int32) - label_q.to(torch.int32)


def cross_entropy_loss(logits_q: torch.Tensor, out_scale: float, out_zp: int,
                       label_q: torch.Tensor, in_scale: float) -> torch.Tensor:
    """``sum(label * log(softmax(pred)))`` on dequantized values
    (``update_layer.rs:334-345``)."""
    dev = logits_q.device
    sm = softmax(logits_q, in_scale=in_scale, out_scale=out_scale, out_zp=out_zp)
    scale, zp = const_f32(out_scale, dev), const_f32(out_zp, dev)
    sm_f = scale * (f32(sm) - zp)
    label_f = scale * (f32(label_q) - zp)
    return torch.sum(label_f * torch.log(sm_f))
