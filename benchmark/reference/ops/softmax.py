"""Quantized Softmax (reference R10, ``src/ops/softmax.rs``).

The reference deliberately does NOT subtract the input zero-point:

    e_i  = f32(q_i) * in_scale            # src/ops/softmax.rs:36
    sum  = sum_i expf(e_i)
    out  = quantize(expf(e_i) / sum, out_scale, out_zp)

The sum is taken left to right over the entries, as the flat kernel
(``csrc/flatpack.cu``) takes it, so the port's backends agree bit for bit.
``torch.exp`` may differ from ``expf`` or XLA's exp by an ULP, and the JAX
package sums in another order; the parity contract with it is <= 1 output
LSB.
"""

from __future__ import annotations

import torch

from ..core.numerics import const_f32, f32, round_away, saturating_cast


def softmax(
    x: torch.Tensor,  # [B, N] quantized ints
    *,
    in_scale: float,
    out_scale: float,
    out_zp: int,
) -> torch.Tensor:
    out_dtype = x.dtype
    dev = x.device
    e = f32(x) * const_f32(in_scale, dev)  # NO zero-point subtraction (by design)
    ex = torch.exp(e)
    total = ex[..., 0:1]
    for i in range(1, ex.shape[-1]):
        total = total + ex[..., i:i + 1]
    y = round_away(ex / total / const_f32(out_scale, dev) + const_f32(out_zp, dev))
    return saturating_cast(y, out_dtype)
