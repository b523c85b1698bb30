"""QUANTIZE op: requantize int8/uint8 -> int8/uint8 with new parameters.

    y = roundf((in_s * (f32(x) - f32(in_zp))) / out_s + out_zp), saturating cast

as ``microflow_tpu.ops.quantize_op`` computes it (the reference's own
codegen for this op was dead code).
"""

from __future__ import annotations

import torch

from ..core.numerics import const_f32, f32, round_away, saturating_cast


def quantize_op(
    x: torch.Tensor,
    *,
    in_scale: float,
    in_zp: int,
    out_scale: float,
    out_zp: int,
    out_dtype=torch.int8,
) -> torch.Tensor:
    dev = x.device
    deq = const_f32(in_scale, dev) * (f32(x) - const_f32(in_zp, dev))
    y = round_away(deq / const_f32(out_scale, dev) + const_f32(out_zp, dev))
    return saturating_cast(y, out_dtype)
