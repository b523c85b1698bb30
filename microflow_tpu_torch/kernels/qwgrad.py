"""A 1x1 conv's per-sample weight gradients folded into its accumulator
(CUDA, ``csrc/qwgrad.cu``): the trainer's backward for a 1x1, stride-1,
unpadded Conv2D on the card.

The plain chain (``qwgrad_reference``: ``gradients.conv_weight_grad_sample``
then ``optimizer.plain_fold``) builds each sample's normalized, rounded
and saturated gradient as a [B, F, 1, 1, C] tensor, through int64, float64
and f32 intermediates, and sums it over the batch.  The kernel keeps all of
that in registers and writes only the new accumulator.  It computes the
plain sum, which is the fold of record only where the fold cannot
saturate: ``takes_kernel`` is the kernel's rule for what it can compute,
which ``train.trainer.fold_path`` reads in picking a layer's fold.  The JAX
package has no such kernel (its backward is plain ``jnp``).  CUDA tensors
launch the kernel, CPU tensors run ``qwgrad_reference``.
"""

from __future__ import annotations

import torch

from ..compiler.ir import Conv2DLayer
from ..train import gradients, optimizer
from . import LAUNCHES, build


def takes_kernel(layer, x_q: torch.Tensor, gradient_mode: str, bound) -> bool:
    """Whether the kernel can fold ``layer``'s weight gradient of the batch
    ``x_q``: on CUDA, quantized gradients, a 1x1, stride-1, unpadded Conv2D
    on an int8 input, and a fold bound held as a host int under which the
    fold is the plain sum (``train.trainer.fold_path`` decides)."""
    return (x_q.device.type == "cuda" and gradient_mode == "quantized"
            and isinstance(layer, Conv2DLayer) and layer.geom.is_pointwise()
            and x_q.dtype == torch.int8 and isinstance(bound, int)
            and optimizer.fold_is_plain_sum(bound, x_q.shape[0]))


def qwgrad_reference(layer: Conv2DLayer, x_q: torch.Tensor, md: torch.Tensor,
                     acc: torch.Tensor) -> torch.Tensor:
    """The plain torch version of the kernel: the trainer's chain."""
    return optimizer.plain_fold(gradients.conv_weight_grad_sample(layer, x_q, md), acc)


def qwgrad(layer: Conv2DLayer, x_q: torch.Tensor, md: torch.Tensor,
           acc: torch.Tensor) -> torch.Tensor:
    """``acc`` [F, 1, 1, C] int32 plus the batch's normalized per-sample
    weight gradients of the 1x1 conv ``layer``, from its input ``x_q``
    [B, H, W, C] int8 and the masked dOut ``md`` [B, H, W, F] int32
    (``gradients.mask_d_out``), wrapped to i32; a new tensor."""
    if x_q.device.type == "cpu":
        return qwgrad_reference(layer, x_q, md, acc)
    if x_q.device.type != "cuda":
        raise ValueError(f"qwgrad: unsupported device {x_q.device}")
    if not layer.geom.is_pointwise():
        raise ValueError(f"qwgrad: layer {layer.index} is not a 1x1, stride-1, unpadded conv")
    geom = layer.geom
    F_, _, _, C = layer.filters.shape
    B, P = x_q.shape[0], geom.out_rows * geom.out_cols
    for t, what, dtype, shape in ((x_q, "x_q", torch.int8, (B, geom.in_rows, geom.in_cols, C)),
                                  (md, "md", torch.int32, (B, geom.out_rows, geom.out_cols, F_)),
                                  (acc, "acc", torch.int32, (F_, 1, 1, C))):
        if t.dtype != dtype or t.device != x_q.device or tuple(t.shape) != shape:
            raise ValueError(f"qwgrad: {what} must be {dtype} {shape} on {x_q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    x_q, md, acc = x_q.contiguous(), md.contiguous(), acc.contiguous()
    out = torch.empty_like(acc)
    vec = int(F_ % 4 == 0 and C % 4 == 0 and md.data_ptr() % 16 == 0
              and x_q.data_ptr() % 4 == 0)
    fn = build.library("qwgrad").mf_qwgrad
    rc = build.launch(fn, x_q.device, md.data_ptr(), x_q.data_ptr(), acc.data_ptr(),
                      out.data_ptr(), B, P, F_, C, layer.in_q.zp0, vec)
    build.check(rc, "qwgrad")
    LAUNCHES["qwgrad"] += 1
    return out
