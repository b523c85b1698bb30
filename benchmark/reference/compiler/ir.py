"""Static layer IR: the analog of the reference's tokenized operator
structs (``microflow-macros/src/ops/*.rs``), field for field the same as
``microflow_tpu.compiler.ir`` so a parsed graph can be compared with the
JAX package's.

Everything except the weight/constant arrays is a static Python value
(shapes, strides, quantization parameters, folded requant constants);
``builder.py`` runs the layers eagerly over it.  Trainable arrays
(weights, bias constants C0, FC's derived C2) live in a separate params
dict of torch tensors (``builder.init_params``) so they can be swapped.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.activation import FusedActivation
from ..core.tensor import ViewGeometry


@dataclass
class QuantInfo:
    """Per-tensor (len 1) or per-channel quantization parameters."""

    scale: np.ndarray  # f32 [Q]
    zero_point: np.ndarray  # i64 [Q]

    @property
    def scale0(self) -> np.float32:
        return np.float32(self.scale[0])

    @property
    def zp0(self) -> int:
        return int(self.zero_point[0])


@dataclass
class FullyConnectedLayer:
    """Reference C5 + R6."""

    index: int
    weights: np.ndarray  # [K, N] int8/uint8 (transposed from tflite [N, K])
    in_q: QuantInfo
    w_q: QuantInfo
    bias_q: QuantInfo
    out_q: QuantInfo
    c0: np.ndarray  # f32 [N]
    c1: np.float32
    c2: np.ndarray  # i32 [N]  (in_zp * colsum(W) -- refreshed after training)
    c3: int
    activation: FusedActivation
    flatten_input: bool  # reference `reshape` flag (input rank != 2)
    out_shape: tuple  # per-sample output shape


@dataclass
class Conv2DLayer:
    """Reference C6 + R7."""

    index: int
    filters: np.ndarray  # [F, KH, KW, C]
    in_q: QuantInfo
    w_q: QuantInfo
    bias_q: QuantInfo
    out_q: QuantInfo
    c0: np.ndarray  # f32 [F]
    c1: np.ndarray  # f32 [Q] (per-channel) -- broadcast to [F] at build
    geom: ViewGeometry
    activation: FusedActivation
    out_shape: tuple


@dataclass
class DepthwiseConv2DLayer:
    """Reference C7 + R8."""

    index: int
    weights: np.ndarray  # [KH, KW, CH]
    in_q: QuantInfo
    w_q: QuantInfo
    bias_q: QuantInfo
    out_q: QuantInfo
    c0: np.ndarray  # f32 [CH]
    c1: np.ndarray  # f32 [Q]
    geom: ViewGeometry
    activation: FusedActivation
    out_shape: tuple


@dataclass
class AveragePool2DLayer:
    """Reference C8 + R9."""

    index: int
    in_q: QuantInfo
    out_q: QuantInfo
    c0: np.float32
    c1: np.float32
    geom: ViewGeometry
    activation: FusedActivation
    out_shape: tuple


@dataclass
class SoftmaxLayer:
    """Reference C9 + R10."""

    index: int
    in_q: QuantInfo
    out_q: QuantInfo
    out_shape: tuple


@dataclass
class ReshapeLayer:
    """Reference C9 + R11.  Quant params pass through unchanged but are
    recorded so a loss can read them when it lands on a reshape output."""

    index: int
    out_shape: tuple  # per-sample target shape
    out_q: "QuantInfo | None" = None


@dataclass
class QuantizeLayer:
    """Requantization op (reference C10 was dead code; implemented here)."""

    index: int
    in_q: QuantInfo
    out_q: QuantInfo
    out_dtype: np.dtype
    out_shape: tuple


Layer = (
    FullyConnectedLayer
    | Conv2DLayer
    | DepthwiseConv2DLayer
    | AveragePool2DLayer
    | SoftmaxLayer
    | ReshapeLayer
)


@dataclass
class Graph:
    """Parsed + folded model, ready for the builder."""

    name: str
    layers: list
    input_shape: tuple  # per-sample, e.g. (1,) for sine, (1960,) for speech
    input_q: QuantInfo
    input_dtype: np.dtype
    output_shape: tuple
    output_q: QuantInfo
    output_dtype: np.dtype
