"""Requantization-constant folding -- the heart of the compiler.

Exact float32 reproductions of the reference preprocessors:

* FullyConnected: ``microflow-macros/src/ops/fully_connected.rs:96-119``
* Conv2D:         ``microflow-macros/src/ops/conv_2d.rs:90-110``
* DepthwiseConv:  ``microflow-macros/src/ops/depthwise_conv_2d.rs:96-116``
* AveragePool2D:  ``microflow-macros/src/ops/average_pool_2d.rs:73-79``
* Add:            TFLite's ``kernels/add.cc`` (``Prepare``, int8), which
  MicroFlow lacks: integer multipliers and shifts from double, as
  ``quantization_util.cc`` makes them (``preprocess_add``)

All arithmetic is done in numpy float32 with the same association order as
the Rust code so the folded constants are bit-identical.

Like the reference, the folding step is native: when the C++ library
(``native/tflite_parser.cpp``, ``mf_fold_*``) loads, it does the work;
the numpy versions below are the fallback and the oracle the native fold
is tested against (``tests/test_torch_native.py``).
"""

from __future__ import annotations

import math

import numpy as np

from .ir import QuantInfo

F32 = np.float32
I32 = np.int32


def _native():
    """The native module when its library loads, else None."""
    from .. import native

    return native if native.available() else None


def _get(arr, i):
    """Reference ``.get(i).copied().unwrap_or(arr[0])`` pattern."""
    return arr[i] if i < len(arr) else arr[0]


def preprocess_fully_connected(
    in_q: QuantInfo, w_q: QuantInfo, bias: np.ndarray, bias_q: QuantInfo, out_q: QuantInfo,
    weights: np.ndarray,
) -> tuple[np.ndarray, np.float32, np.ndarray, int]:
    """Returns (C0 [N] f32, C1 f32, C2 [N] i32, C3 i32)."""
    nat = _native()
    if nat is not None and weights.dtype == np.int8:
        return nat.fold_fc(
            in_q.scale0, in_q.zp0, w_q.scale0, w_q.zp0,
            bias_q.scale0, bias_q.zp0, out_q.scale0, bias, weights,
        )
    s = F32(bias_q.scale0) / F32(out_q.scale0)
    c0 = s * (bias.astype(np.int64) - bias_q.zp0).astype(F32)
    c1 = F32(in_q.scale0) * F32(w_q.scale0) / F32(out_q.scale0)
    c2 = (weights.astype(np.int64).sum(axis=0) * in_q.zp0).astype(I32)
    c3 = int(weights.shape[0]) * in_q.zp0 * w_q.zp0
    return c0.astype(F32), F32(c1), c2, int(c3)


def preprocess_conv_2d(
    in_q: QuantInfo, w_q: QuantInfo, bias: np.ndarray, bias_q: QuantInfo, out_q: QuantInfo,
    num_filters: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (C0 [F] f32, C1 [Q] f32)."""
    nat = _native()
    if nat is not None:
        return nat.fold_conv(
            in_q.scale0, out_q.scale0, w_q.scale,
            bias_q.scale, bias_q.zero_point, bias, num_filters,
        )
    c0 = np.empty(num_filters, F32)
    for b in range(num_filters):
        bs = F32(_get(bias_q.scale, b))
        bz = int(_get(bias_q.zero_point, b))
        c0[b] = bs / F32(out_q.scale0) * F32(int(bias[b]) - bz)
    c1 = np.empty(len(w_q.scale), F32)
    for q in range(len(w_q.scale)):
        c1[q] = F32(in_q.scale0) * F32(w_q.scale[q]) / F32(out_q.scale0)
    return c0, c1


def preprocess_depthwise_conv_2d(
    in_q: QuantInfo, w_q: QuantInfo, bias: np.ndarray, bias_q: QuantInfo, out_q: QuantInfo,
    num_channels: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Same scheme as Conv2D, keyed on the weights' channel count."""
    return preprocess_conv_2d(in_q, w_q, bias, bias_q, out_q, num_channels)


def preprocess_average_pool_2d(in_q: QuantInfo, out_q: QuantInfo) -> tuple[np.float32, np.float32]:
    """Returns (C0, C1) with C1 = out_zp - (in_s * in_zp) / out_s."""
    nat = _native()
    if nat is not None:
        return nat.fold_avgpool(in_q.scale0, in_q.zp0, out_q.scale0, out_q.zp0)
    c0 = F32(in_q.scale0) / F32(out_q.scale0)
    c1 = F32(out_q.zp0) - (F32(in_q.scale0) * F32(in_q.zp0)) / F32(out_q.scale0)
    return F32(c0), F32(c1)


ADD_LEFT_SHIFT = 20  # add.cc's left shift for int8 and uint8 inputs


def _round_half_away(x: float) -> int:
    """``std::round`` of a double: half away from zero."""
    return math.floor(x + 0.5) if x >= 0 else -math.floor(-x + 0.5)


def quantize_multiplier_smaller_than_one(m: float) -> tuple[int, int]:
    """TFLite's ``QuantizeMultiplierSmallerThanOneExp``: a double ``m`` in
    (0, 1) as ``(q, e)``, an int32 multiplier ``q`` in [2**30, 2**31) and a
    shift ``e <= 0``, with ``m`` ~ ``q * 2**(e - 31)``.  A shift below -31
    gives ``(0, 0)``, as there."""
    if not 0.0 < m < 1.0:
        raise ValueError(f"multiplier {m!r} is not in (0, 1)")
    q, shift = math.frexp(m)
    q_fixed = _round_half_away(q * (1 << 31))
    if q_fixed == 1 << 31:
        q_fixed //= 2
        shift += 1
    if shift < -31:
        return 0, 0
    return int(q_fixed), int(shift)


def add_activation_range(activation, out_q: QuantInfo) -> tuple[int, int]:
    """TFLite's ``CalculateActivationRangeQuantized`` for int8:
    ``zp + round(f / scale)`` of 0 and 6, in f32, clamped to the int8
    range."""
    from ..core.activation import FusedActivation

    scale, zp = F32(out_q.scale0), out_q.zp0

    def quantize(f: float) -> int:
        return zp + _round_half_away(float(F32(f) / scale))

    lo, hi = -128, 127
    if activation is FusedActivation.RELU:
        lo = max(lo, quantize(0.0))
    elif activation is FusedActivation.RELU6:
        lo, hi = max(lo, quantize(0.0)), min(hi, quantize(6.0))
    return lo, hi


def preprocess_add(in1_q: QuantInfo, in2_q: QuantInfo, out_q: QuantInfo, activation) -> dict:
    """``AddLayer``'s constants, as ``add.cc`` prepares an int8 ``ADD``: both
    inputs brought to twice the larger input scale, the sum to the
    output's.  Returns the keyword arguments of ``AddLayer`` after
    ``index`` and the quantization."""
    s1, s2, so = F32(in1_q.scale0), F32(in2_q.scale0), F32(out_q.scale0)
    twice_max = float(F32(2) * max(s1, s2))
    m1, e1 = quantize_multiplier_smaller_than_one(float(s1) / twice_max)
    m2, e2 = quantize_multiplier_smaller_than_one(float(s2) / twice_max)
    mo, eo = quantize_multiplier_smaller_than_one(
        twice_max / float(F32(1 << ADD_LEFT_SHIFT) * so))
    lo, hi = add_activation_range(activation, out_q)
    return dict(left_shift=ADD_LEFT_SHIFT, in1_multiplier=m1, in1_shift=e1,
                in2_multiplier=m2, in2_shift=e2, out_multiplier=mo, out_shift=eo,
                act_min=lo, act_max=hi)
