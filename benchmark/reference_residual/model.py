"""The plain reference of a residual int8 ``.tflite`` model (MobileNetV2's
inverted-residual blocks joined by ``ADD``), laid out like
``benchmark/reference/model.py`` (``harness.reference_of``).

What it reuses of ``benchmark/reference/``, by import and unchanged: the
flatbuffer reader, the parser's helpers, the numpy fold, the IR classes,
the layer functions (``apply_layer``, ``init_params``) and ``to_int4_grid``.
What it adds:

* ``parse(path)``: reads every operator of subgraph 0 and records, for each
  layer, the tensor ids it reads and writes (``Graph.reads``,
  ``Graph.writes``).  Conv, depthwise, pool, FC, reshape and softmax become
  the frozen IR's instances, folded by the frozen fold; an ``ADD`` becomes an
  ``Add`` with an ``out_shape`` and its own integer constants, which
  ``costs.py`` counts as 0 MACs and 0 weight bytes.
* ``Add``: TFLite's int8 ``ADD`` as its documentation and
  ``reference/integer_ops/add.h`` describe it: both inputs moved to their
  zero points and shifted left by 20, each brought to twice the larger
  input scale, summed, brought to the output scale, the output zero point
  added and the fused activation's range clamped.  Each scaling by a real
  multiplier ``M < 1`` is an int32 multiplier ``q`` (2**30 <= q < 2**31)
  and a right shift ``r``, ``M = q * 2**(-31 - r)``: the product with ``q``
  rounded to nearest at 2**31 (ties up), then divided by ``2**r`` rounded
  to nearest with ties away from zero.
* ``Reference.forward``: walks the layers by tensor id, a block of rows at
  a time, and drops each tensor after its last reader.

``int4=True`` is the benchmark's control, as in the frozen reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..reference.compiler import folding
from ..reference.compiler.ir import (
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    QuantInfo,
    ReshapeLayer,
    SoftmaxLayer,
)
from ..reference.compiler.ir import Graph as ChainGraph
from ..reference.core.activation import FusedActivation
from ..reference.core.numerics import torch_dtype
from ..reference.core.quantize import dequantize, quantize
from ..reference.core.tensor import ViewGeometry
from ..reference.frontend import tflite
from ..reference.frontend.parser import (
    _activation,
    _padding,
    _per_sample,
    _quant_info,
    _tensor_data,
)
from ..reference.model import apply_layer, init_params, to_int4_grid  # noqa: F401
from ..reference.train import optimizer  # noqa: F401

# builtin operator codes of the TFLite schema
ADD, AVERAGE_POOL_2D, CONV_2D, DEPTHWISE_CONV_2D, FULLY_CONNECTED = 0, 1, 3, 4, 9
RESHAPE, SOFTMAX = 22, 25
LEFT_SHIFT = 20  # TFLite's for int8 ADD inputs
BLOCK = 128  # rows a step of forward's walk


def quantized_multiplier(real: float) -> tuple[int, int]:
    """``real`` in (0, 1) as ``(q, r)``: ``q`` in [2**30, 2**31), ``r >= 0``,
    ``real ~ q * 2**(-31 - r)``, ``q`` rounded half away from zero; a
    multiplier too small for 31 right shifts is ``(0, 0)``."""
    mantissa, exponent = math.frexp(real)  # real = mantissa * 2**exponent, 0.5 <= mantissa < 1
    q = math.floor(mantissa * 2**31 + 0.5)
    if q == 2**31:
        q, exponent = 2**30, exponent + 1
    if exponent < -31:
        return 0, 0
    return q, -exponent


@dataclass
class Add:
    """An int8 ``ADD`` of two tensors of one shape, with its constants."""

    index: int
    in1_zp: int
    in2_zp: int
    out_zp: int
    in1: tuple  # (q, r) of in1_scale / (2 * max input scale)
    in2: tuple
    out: tuple  # (q, r) of 2 * max input scale / (2**20 * out_scale)
    lo: int
    hi: int
    out_shape: tuple


def _scale_by(v: torch.Tensor, qr: tuple) -> torch.Tensor:
    """``v * q * 2**(-31 - r)`` in int64, rounded as ``Add`` says."""
    q, r = qr
    v = (v * q + 2**30) >> 31
    if r == 0:
        return v
    return torch.sign(v) * ((v.abs() + 2 ** (r - 1)) >> r)


def add(layer: Add, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    a = (x1.to(torch.int64) - layer.in1_zp) * 2**LEFT_SHIFT
    b = (x2.to(torch.int64) - layer.in2_zp) * 2**LEFT_SHIFT
    total = _scale_by(a, layer.in1) + _scale_by(b, layer.in2)
    y = _scale_by(total, layer.out) + layer.out_zp
    return y.clamp(layer.lo, layer.hi).to(torch.int8)


def _add_layer(index: int, in1: QuantInfo, in2: QuantInfo, out: QuantInfo, activation,
               out_shape: tuple) -> Add:
    s1, s2, so = (float(np.float32(q.scale0)) for q in (in1, in2, out))
    twice = 2.0 * max(s1, s2)

    def on_grid(f: float) -> int:  # zp + round(f / scale) in f32, half away from zero
        v = float(np.float32(f) / np.float32(so))
        return out.zp0 + int(math.copysign(math.floor(abs(v) + 0.5), v))

    lo, hi = -128, 127
    if activation is FusedActivation.RELU:
        lo = max(lo, on_grid(0.0))
    elif activation is FusedActivation.RELU6:
        lo, hi = max(lo, on_grid(0.0)), min(hi, on_grid(6.0))
    return Add(index, in1.zp0, in2.zp0, out.zp0, quantized_multiplier(s1 / twice),
               quantized_multiplier(s2 / twice), quantized_multiplier(twice / (2**LEFT_SHIFT * so)),
               lo, hi, out_shape)


@dataclass
class Graph(ChainGraph):
    """The frozen IR's graph, with the tensor ids each layer reads and
    writes and the graph's input and output ids."""

    reads: list = field(default_factory=list)
    writes: list = field(default_factory=list)
    input_id: int = 0
    output_id: int = 0


def _geometry(in_t, out_t, kh, kw, opts) -> ViewGeometry:
    return ViewGeometry(in_rows=in_t.shape[1], in_cols=in_t.shape[2], k_rows=kh, k_cols=kw,
                        out_rows=out_t.shape[1], out_cols=out_t.shape[2],
                        stride_rows=opts.stride_h, stride_cols=opts.stride_w,
                        padding=_padding(opts.padding))


def parse(path: str) -> Graph:
    """Parse and fold the model at ``path``, with its wiring."""
    model = tflite.load_model(path)
    sg = model.subgraphs[0]
    t = sg.tensors
    if len(model.subgraphs) != 1 or len(sg.inputs) != 1 or len(sg.outputs) != 1:
        raise NotImplementedError("one subgraph with one input and one output only")
    layers, reads, writes = [], [], []
    for i, op in enumerate(sg.operators):
        code = model.operator_codes[op.opcode_index].op
        out_t = t[op.outputs[0]]
        out_q, out_shape = _quant_info(out_t), _per_sample(out_t.shape)
        in_t = t[op.inputs[0]]
        in_q = _quant_info(in_t)
        if code in (CONV_2D, DEPTHWISE_CONV_2D, FULLY_CONNECTED):
            w_t, b_t = t[op.inputs[1]], t[op.inputs[2]]
            w_q, bias_q = _quant_info(w_t), _quant_info(b_t)
            bias = _tensor_data(model, b_t).reshape(-1)
        if code == CONV_2D:
            opts = op.conv_2d_options()
            filters = _tensor_data(model, w_t)
            c0, c1 = folding.preprocess_conv_2d(in_q, w_q, bias, bias_q, out_q, filters.shape[0])
            layer = Conv2DLayer(i, filters, in_q, w_q, bias_q, out_q, c0, c1,
                                _geometry(in_t, out_t, filters.shape[1], filters.shape[2], opts),
                                _activation(opts.fused_activation_function), out_shape)
        elif code == DEPTHWISE_CONV_2D:
            opts = op.depthwise_conv_2d_options()
            if in_t.shape[3] != w_t.shape[3]:
                raise NotImplementedError(f"depthwise #{i}: a depth multiplier")
            weights = _tensor_data(model, w_t)[0]
            c0, c1 = folding.preprocess_depthwise_conv_2d(in_q, w_q, bias, bias_q, out_q,
                                                          weights.shape[2])
            layer = DepthwiseConv2DLayer(
                i, weights, in_q, w_q, bias_q, out_q, c0, c1,
                _geometry(in_t, out_t, weights.shape[0], weights.shape[1], opts),
                _activation(opts.fused_activation_function), out_shape)
        elif code == FULLY_CONNECTED:
            opts = op.fully_connected_options()
            weights = _tensor_data(model, w_t).T.copy()
            c0, c1, c2, c3 = folding.preprocess_fully_connected(in_q, w_q, bias, bias_q, out_q,
                                                                weights)
            layer = FullyConnectedLayer(i, weights, in_q, w_q, bias_q, out_q, c0, c1, c2, c3,
                                        _activation(opts.fused_activation_function),
                                        len(in_t.shape) != 2, out_shape)
        elif code == AVERAGE_POOL_2D:
            opts = op.pool_2d_options()
            c0, c1 = folding.preprocess_average_pool_2d(in_q, out_q)
            layer = AveragePool2DLayer(
                i, in_q, out_q, c0, c1,
                _geometry(in_t, out_t, opts.filter_height, opts.filter_width, opts),
                _activation(opts.fused_activation_function), out_shape)
        elif code == SOFTMAX:
            layer = SoftmaxLayer(i, in_q, out_q, out_shape)
        elif code == RESHAPE:
            layer = ReshapeLayer(i, out_shape, out_q)
        elif code == ADD:
            in2_t = t[op.inputs[1]]
            if in_t.shape != in2_t.shape or in_t.shape != out_t.shape:
                raise NotImplementedError(f"ADD #{i}: shapes differ (a broadcast)")
            options = op._options
            act = tflite.ActivationFunctionType(options.int8(0) if options is not None else 0)
            layer = _add_layer(i, in_q, _quant_info(in2_t), out_q, _activation(act), out_shape)
        else:
            raise NotImplementedError(f"operator code {code} #{i}")
        layers.append(layer)
        reads.append(tuple(op.inputs[:2] if code == ADD else op.inputs[:1]))
        writes.append(op.outputs[0])
    inp, out = t[sg.inputs[0]], t[sg.outputs[0]]
    return Graph(name=sg.name or "model", layers=layers, input_shape=_per_sample(inp.shape),
                 input_q=_quant_info(inp), input_dtype=np.dtype(inp.type.np_dtype),
                 output_shape=_per_sample(out.shape), output_q=_quant_info(out),
                 output_dtype=np.dtype(out.type.np_dtype), reads=reads, writes=writes,
                 input_id=sg.inputs[0], output_id=sg.outputs[0])


class Reference:
    """A parsed, folded residual model and its plain forward on ``device``."""

    def __init__(self, path: str, device, int4: bool = False):
        self.graph = parse(path)
        self.device = torch.device(device)
        self.params = init_params(self.graph, self.device, snap_int4=int4)
        g = self.graph
        last = {}
        for i, ids in enumerate(g.reads):
            for tid in ids:
                last[tid] = i
        self._drop = [[tid for tid, j in last.items() if j == i and tid != g.output_id]
                      for i in range(len(g.layers))]

    @property
    def input_dtype(self) -> torch.dtype:
        return torch_dtype(self.graph.input_dtype)

    def quantize(self, x) -> torch.Tensor:
        g = self.graph
        x = torch.as_tensor(x, device=self.device).to(torch.float32)
        return quantize(x, g.input_q.scale0, g.input_q.zp0, dtype=self.input_dtype)

    def dequantize(self, yq: torch.Tensor) -> torch.Tensor:
        g = self.graph
        return dequantize(yq, g.output_q.scale0, g.output_q.zp0)

    def _walk(self, x: torch.Tensor) -> torch.Tensor:
        g = self.graph
        live = {g.input_id: x}
        for layer, ids, out, drop in zip(g.layers, g.reads, g.writes, self._drop):
            if isinstance(layer, Add):
                y = add(layer, live[ids[0]], live[ids[1]])
            else:
                y = apply_layer(layer, self.params, live[ids[0]])
            live[out] = y
            for tid in drop:
                del live[tid]
        return live[g.output_id]

    @torch.no_grad()
    def forward(self, xq: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
        """int [B, *input_shape] -> int [B, *output_shape], ``block`` rows
        at a time, so that a batch of 1024 at 224x224 fits beside the
        program's outputs."""
        return torch.cat([self._walk(xq[s:s + block].to(self.device))
                          for s in range(0, xq.shape[0], block)])
