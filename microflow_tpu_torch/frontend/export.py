"""Trained-model export: Graph (+ current params) -> ``.tflite`` bytes, the
port's copy of ``microflow_tpu.frontend.export``: given the same graph, the
same params and the same description, both write the same bytes.

A trained ``TrainableModel`` round-trips back to a standard ``.tflite``
that this engine or any TFLite runtime loads (the reference keeps its
trained weights in the MCU's RAM, ``microflow-train-macros``).

Inverse of the parser's decode transforms (``frontend/parser.py``):

* FC weights are stored ``[K, N]`` (transposed at parse) -> re-emit
  ``[N, K]``; dw weights ``[KH, KW, CH]`` -> ``[1, KH, KW, CH]``.
* The folded bias constant ``C0 = bias_s/out_s * (bias - bias_zp)``
  (``compiler/folding.py``) is inverted to an integer bias tensor by
  ``bias = round(C0 * out_s / bias_s) + bias_zp``.  For an untrained
  model this recovers the original integers exactly (C0 was computed
  from them), so parse -> export -> parse is bit-identical.  After
  training, C0 is a free f32 parameter (the reference trains the
  folded constant directly, ``update_layer.rs``), so export quantizes
  it to the nearest representable bias, the usual quantize-on-export
  step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compiler.ir import (AveragePool2DLayer, Conv2DLayer,
                           DepthwiseConv2DLayer, FullyConnectedLayer, Graph,
                           QuantizeLayer, ReshapeLayer, SoftmaxLayer, refuse_wiring)
from ..core.activation import FusedActivation
from ..core.tensor import ViewPadding
from .tflite import ActivationFunctionType as Act
from .tflite import BuiltinOperator as Op
from .tflite import Padding, TensorType
from .writer import ModelWriter

_ACT = {FusedActivation.NONE: Act.NONE, FusedActivation.RELU: Act.RELU,
        FusedActivation.RELU6: Act.RELU6}

_TT = {np.dtype(np.int8): TensorType.INT8, np.dtype(np.uint8): TensorType.UINT8,
       np.dtype(np.int32): TensorType.INT32}


def _pad(geom) -> Padding:
    return Padding.SAME if geom.padding is ViewPadding.SAME else Padding.VALID


def _bias_from_c0(c0, bias_q, out_q, per_channel: bool) -> np.ndarray:
    """Invert folding.py's C0.

    ``per_channel`` mirrors which quant params the forward fold consumed:
    conv/dwconv fold with per-index ``.get(i).unwrap_or(arr[0])`` scales
    (``preprocess_conv_2d``), FC folds every output with ``scale0``/``zp0``
    (``preprocess_fully_connected``) -- inverting an FC layer with
    per-index params would recover wrong integers whenever the bias
    tensor carries per-channel quantization.

    Exactness bound: C0 is computed at parse time in f32 as
    ``(bias - bias_zp) * (bias_s / out_s)``, one multiply on an exact
    integer difference, so the relative error is <= 1 ulp and ``round()``
    recovers the original integer exactly while
    ``|bias - bias_zp| < 2**23`` (f32 mantissa headroom for a <0.5-LSB
    absolute error).  All reference models sit orders of magnitude below
    this; asserted here so a model beyond the bound fails loudly instead
    of silently exporting shifted integers."""
    c0 = np.asarray(c0, np.float64)
    n = len(c0)
    if per_channel:
        bs = np.asarray([bias_q.scale[i] if i < len(bias_q.scale) else bias_q.scale[0]
                         for i in range(n)], np.float64)
        bz = np.asarray([bias_q.zero_point[i] if i < len(bias_q.zero_point)
                         else bias_q.zero_point[0] for i in range(n)], np.int64)
    else:
        bs = np.full(n, float(bias_q.scale0), np.float64)
        bz = np.full(n, int(bias_q.zp0), np.int64)
    diff = c0 * float(out_q.scale0) / bs  # ~ (bias - bias_zp)
    if np.any(np.abs(diff) >= 2**23):
        raise ValueError(
            "bias magnitude exceeds the f32 exact-roundtrip bound (|bias - "
            "bias_zp| >= 2**23); exported integers would drift from the "
            "parsed model")
    vals = np.round(diff).astype(np.int64) + bz
    return np.clip(vals, np.iinfo(np.int32).min, np.iinfo(np.int32).max).astype(np.int32)


def _param(params, layer, key):
    """``params[f"layer{i}"][key]`` as a numpy array (a tensor on any device
    is copied to the host), or None."""
    entry = (params or {}).get(f"layer{layer.index}")
    if entry is None or key not in entry:
        return None
    value = entry[key]
    return value.cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def export_tflite(graph: Graph, params: dict | None = None,
                  description: str = "microflow_tpu_torch export") -> bytes:
    """Serialize ``graph`` (with ``params`` overriding trained arrays: torch
    tensors on any device, or numpy arrays) to TFLite flatbuffer bytes.
    ``CompiledModel.export()`` is the user-facing wrapper.  A residual graph
    (an ``ADD``, ``graph.wiring``) raises ``NotImplementedError``."""
    refuse_wiring(graph, "export")
    m = ModelWriter(description)
    in_shape = tuple(graph.input_shape)
    cur_tt = _TT[np.dtype(graph.input_dtype)]  # activation dtype, may change at QUANTIZE
    cur = m.tensor([1, *in_shape], cur_tt,
                   graph.input_q.scale, graph.input_q.zero_point, name="input")
    inp = cur

    for layer in graph.layers:
        if isinstance(layer, FullyConnectedLayer):
            w = _param(params, layer, "weights")
            w = np.asarray(w if w is not None else layer.weights)
            c0 = _param(params, layer, "c0")
            c0 = c0 if c0 is not None else layer.c0
            bias = _bias_from_c0(c0, layer.bias_q, layer.out_q, per_channel=False)
            t_w = m.tensor(list(w.T.shape), _TT[w.dtype], layer.w_q.scale,
                           layer.w_q.zero_point, data=w.T, name="fc_w")
            t_b = m.tensor([len(bias)], TensorType.INT32, layer.bias_q.scale,
                           layer.bias_q.zero_point, data=bias, name="fc_b")
            out = m.tensor([1, *layer.out_shape], cur_tt,
                           layer.out_q.scale, layer.out_q.zero_point, name="fc_out")
            m.add_op(Op.FULLY_CONNECTED, [cur, t_w, t_b], [out],
                     m.fc_options(_ACT[layer.activation]))
        elif isinstance(layer, Conv2DLayer):
            w = _param(params, layer, "weights")
            w = np.asarray(w if w is not None else layer.filters)
            c0 = _param(params, layer, "c0")
            c0 = c0 if c0 is not None else layer.c0
            bias = _bias_from_c0(c0, layer.bias_q, layer.out_q, per_channel=True)
            t_w = m.tensor(list(w.shape), _TT[w.dtype], layer.w_q.scale,
                           layer.w_q.zero_point, data=w, name="conv_w")
            t_b = m.tensor([len(bias)], TensorType.INT32, layer.bias_q.scale,
                           layer.bias_q.zero_point, data=bias, name="conv_b")
            out = m.tensor([1, *layer.out_shape], cur_tt,
                           layer.out_q.scale, layer.out_q.zero_point, name="conv_out")
            g = layer.geom
            m.add_op(Op.CONV_2D, [cur, t_w, t_b], [out],
                     m.conv_options(_pad(g), (g.stride_rows, g.stride_cols),
                                    _ACT[layer.activation]))
        elif isinstance(layer, DepthwiseConv2DLayer):
            w = _param(params, layer, "weights")
            w = np.asarray(w if w is not None else layer.weights)  # [KH, KW, CH]
            c0 = _param(params, layer, "c0")
            c0 = c0 if c0 is not None else layer.c0
            bias = _bias_from_c0(c0, layer.bias_q, layer.out_q, per_channel=True)
            # per-channel dw quantizes along the channel axis of the
            # tflite [1, KH, KW, CH] layout (quantized_dimension=3,
            # the legacy person_detect convention)
            qdim = 3 if len(layer.w_q.scale) > 1 else 0
            t_w = m.tensor([1, *w.shape], _TT[w.dtype], layer.w_q.scale,
                           layer.w_q.zero_point, data=w[None], name="dw_w",
                           quantized_dimension=qdim)
            t_b = m.tensor([len(bias)], TensorType.INT32, layer.bias_q.scale,
                           layer.bias_q.zero_point, data=bias, name="dw_b")
            out = m.tensor([1, *layer.out_shape], cur_tt,
                           layer.out_q.scale, layer.out_q.zero_point, name="dw_out")
            g = layer.geom
            dm = w.shape[2] // in_shape[-1]
            m.add_op(Op.DEPTHWISE_CONV_2D, [cur, t_w, t_b], [out],
                     m.dwconv_options(_pad(g), (g.stride_rows, g.stride_cols),
                                      dm, _ACT[layer.activation]))
        elif isinstance(layer, AveragePool2DLayer):
            g = layer.geom
            out = m.tensor([1, *layer.out_shape], cur_tt,
                           layer.out_q.scale, layer.out_q.zero_point, name="pool_out")
            m.add_op(Op.AVERAGE_POOL_2D, [cur], [out],
                     m.pool_options(_pad(g), (g.stride_rows, g.stride_cols),
                                    (g.k_rows, g.k_cols), _ACT[layer.activation]))
        elif isinstance(layer, ReshapeLayer):
            q = layer.out_q if layer.out_q is not None else graph.output_q
            out = m.tensor([1, *layer.out_shape], cur_tt,
                           q.scale, q.zero_point, name="reshape_out")
            m.add_op(Op.RESHAPE, [cur], [out],
                     m.reshape_options([1, *layer.out_shape]))
        elif isinstance(layer, SoftmaxLayer):
            out = m.tensor([1, *layer.out_shape], _TT[np.dtype(graph.output_dtype)],
                           layer.out_q.scale, layer.out_q.zero_point, name="softmax_out")
            m.add_op(Op.SOFTMAX, [cur], [out], m.softmax_options(1.0))
        elif isinstance(layer, QuantizeLayer):
            out = m.tensor([1, *layer.out_shape], _TT[np.dtype(layer.out_dtype)],
                           layer.out_q.scale, layer.out_q.zero_point, name="quantize_out")
            m.add_op(Op.QUANTIZE, [cur], [out], None)
            cur_tt = _TT[np.dtype(layer.out_dtype)]
        else:
            raise NotImplementedError(f"export: unsupported layer {type(layer).__name__}")
        cur = out
        in_shape = tuple(layer.out_shape)

    return m.finish([inp], [cur])
