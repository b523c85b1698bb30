"""Losses and initial backward gradients (reference R16 part,
``src/update_layer.rs:296-345``), as ``microflow_tpu.train.losses``.

Gradients are integer (i32) differences of quantized buffers: the
reference backpropagates raw quantized-domain deltas, not float grads.
"""

from __future__ import annotations

import torch

from ..ops.softmax import softmax


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
