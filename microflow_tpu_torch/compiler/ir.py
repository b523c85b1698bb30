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


@dataclass
class AddLayer:
    """TFLite's int8 ``ADD`` of two tensors of one shape (``kernels/add.cc``
    prepares it, ``reference/integer_ops/add.h`` runs it), every constant an
    integer (``folding.preprocess_add``).  Per element::

        a = (x1 - in1_zp) << left_shift        (and b from x2 alike)
        s = scale(a, in1_multiplier, in1_shift) + scale(b, in2_multiplier, in2_shift)
        y = clamp(scale(s, out_multiplier, out_shift) + out_zp, act_min, act_max)

    ``scale(v, m, e)`` is gemmlowp's rounding doubling high multiply by ``m``
    then a rounding right shift by ``-e`` (each ``e <= 0``).  It reads two
    tensors, so only a graph with ``Graph.wiring`` holds one.  The JAX
    package has no counterpart."""

    index: int
    in1_q: QuantInfo
    in2_q: QuantInfo
    out_q: QuantInfo
    left_shift: int
    in1_multiplier: int
    in1_shift: int
    in2_multiplier: int
    in2_shift: int
    out_multiplier: int
    out_shift: int
    act_min: int
    act_max: int
    activation: FusedActivation
    out_shape: tuple


@dataclass(frozen=True)
class Wiring:
    """Which tensors a graph's layers read and write, by the model file's
    tensor ids: ``layers[i]`` is layer i's ``(inputs, output)``, ``input``
    and ``output`` the graph's own."""

    input: int
    output: int
    layers: tuple  # ((input ids, output id), ...), one a layer

    def frees(self) -> list[tuple]:
        """After layer i, the tensor ids that no later layer reads (the
        graph's output is kept): one tuple a layer."""
        last = {}
        for i, (ins, _) in enumerate(self.layers):
            for t in ins:
                last[t] = i
        out = [[] for _ in self.layers]
        for t, i in last.items():
            if t != self.output:
                out[i].append(t)
        return [tuple(ts) for ts in out]


def chain_length(graph) -> int:
    """How many leading layers of ``graph`` form a plain chain, the only
    form the one-launch planners take: each reads the output of the layer
    before it (the first, the graph's input) and nothing else, and its
    output is read by the next layer alone.  Every layer of a graph with no
    ``wiring``."""
    w = graph.wiring
    if w is None:
        return len(graph.layers)
    readers: dict = {}
    for i, (ins, _) in enumerate(w.layers):
        for t in ins:
            readers.setdefault(t, set()).add(i)
    prev = w.input
    for i, (ins, out) in enumerate(w.layers):
        if ins != (prev,) or readers.get(out, set()) - {i + 1}:
            return i
        prev = out
    return len(w.layers)


def refuse_wiring(graph, what: str) -> None:
    """Raise ``NotImplementedError`` naming ``ADD`` where ``graph`` is not a
    chain: ``what`` runs chain graphs only."""
    if graph.wiring is not None:
        adds = [layer.index for layer in graph.layers if isinstance(layer, AddLayer)]
        raise NotImplementedError(
            f"{what} runs chain graphs only; {graph.name!r} is a residual graph "
            f"(ADD at layers {adds})")


Layer = (
    FullyConnectedLayer
    | Conv2DLayer
    | DepthwiseConv2DLayer
    | AveragePool2DLayer
    | SoftmaxLayer
    | ReshapeLayer
    | AddLayer
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
    # the tensors each layer reads and writes; None for a chain, in which
    # each layer reads the output of the one before it (every graph the JAX
    # package parses)
    wiring: Wiring | None = None
