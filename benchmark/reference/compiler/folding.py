"""Requantization-constant folding -- the heart of the compiler.

Exact float32 reproductions of the reference preprocessors:

* FullyConnected: ``microflow-macros/src/ops/fully_connected.rs:96-119``
* Conv2D:         ``microflow-macros/src/ops/conv_2d.rs:90-110``
* DepthwiseConv:  ``microflow-macros/src/ops/depthwise_conv_2d.rs:96-116``
* AveragePool2D:  ``microflow-macros/src/ops/average_pool_2d.rs:73-79``

All arithmetic is done in numpy float32 with the same association order as
the Rust code so the folded constants are bit-identical.

The benchmark's frozen copy: the numpy fold only, never a native one.
"""

from __future__ import annotations

import numpy as np

from .ir import QuantInfo

F32 = np.float32
I32 = np.int32



def _get(arr, i):
    """Reference ``.get(i).copied().unwrap_or(arr[0])`` pattern."""
    return arr[i] if i < len(arr) else arr[0]


def preprocess_fully_connected(
    in_q: QuantInfo, w_q: QuantInfo, bias: np.ndarray, bias_q: QuantInfo, out_q: QuantInfo,
    weights: np.ndarray,
) -> tuple[np.ndarray, np.float32, np.ndarray, int]:
    """Returns (C0 [N] f32, C1 f32, C2 [N] i32, C3 i32)."""
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
    c0 = F32(in_q.scale0) / F32(out_q.scale0)
    c1 = F32(out_q.zp0) - (F32(in_q.scale0) * F32(in_q.zp0)) / F32(out_q.scale0)
    return F32(c0), F32(c1)
