"""TFLite graph front-end: flatbuffer -> folded static Graph IR.

The equivalent of the reference's proc-macro entry point
(``microflow-macros/src/lib.rs:46-183``): reads subgraph 0, dispatches the
supported builtin operators, decodes weight buffers, folds the
requantization constants, and emits ``compiler.ir`` layer records.  The
benchmark's frozen copy of the port's Python reader (``tflite.py``) and
numpy fold; it has no native path.
"""

from __future__ import annotations

import numpy as np

from ..compiler import folding
from ..compiler.ir import (
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    Graph,
    QuantInfo,
    QuantizeLayer,
    ReshapeLayer,
    SoftmaxLayer,
)
from ..core.activation import FusedActivation
from ..core.tensor import ViewGeometry, ViewPadding
from . import tflite


def _quant_info(tensor: tflite.Tensor) -> QuantInfo:
    q = tensor.quantization
    scale = q.scale if len(q.scale) else np.ones(1, np.float32)
    zp = q.zero_point if len(q.zero_point) else np.zeros(1, np.int64)
    return QuantInfo(scale=np.asarray(scale, np.float32), zero_point=np.asarray(zp, np.int64))


def _activation(a: tflite.ActivationFunctionType) -> FusedActivation:
    if a == tflite.ActivationFunctionType.NONE:
        return FusedActivation.NONE
    if a == tflite.ActivationFunctionType.RELU:
        return FusedActivation.RELU
    if a == tflite.ActivationFunctionType.RELU6:
        return FusedActivation.RELU6
    raise NotImplementedError(f"unsupported fused activation {a!r}")


def _padding(p: tflite.Padding) -> ViewPadding:
    return ViewPadding.SAME if p == tflite.Padding.SAME else ViewPadding.VALID


def _tensor_data(model: tflite.Model, tensor: tflite.Tensor) -> np.ndarray:
    raw = model.buffer_data(tensor.buffer)
    return np.frombuffer(raw, tensor.type.np_dtype).reshape(tensor.shape)


def _per_sample(shape: list[int]) -> tuple:
    """Drop the leading batch-1 dim; rank-1 tensors stay as-is (the
    reference inserts a leading 1 instead, ``lib.rs:68-70``)."""
    if len(shape) == 1:
        return tuple(shape)
    return tuple(shape[1:])


def parse(path: str, name: str | None = None) -> Graph:
    """Parse and fold the ``.tflite`` model at ``path`` (Python reader,
    numpy fold)."""
    model = tflite.load_model(path)
    # Loud rejection of anything the engine would otherwise silently
    # mis-handle (reference aborts compilation the same way:
    # ``microflow-macros/src/lib.rs:134`` ``abort_call_site!``).  A parity
    # engine must never compile a model it cannot honor bit-exactly.
    n_sg = getattr(model, "num_subgraphs", len(model.subgraphs))
    if n_sg != 1:
        raise NotImplementedError(
            f"model has {n_sg} subgraphs; only single-subgraph models are "
            "supported (the engine would silently run subgraph 0)")
    sg = model.subgraphs[0]
    tensors = sg.tensors
    if len(sg.inputs) != 1 or len(sg.outputs) != 1:
        raise NotImplementedError(
            f"model has {len(sg.inputs)} inputs / {len(sg.outputs)} outputs; "
            "only single-input single-output graphs are supported")

    inp = tensors[sg.inputs[0]]
    out = tensors[sg.outputs[0]]
    layers = []

    def _reject_dilation(opts, what):
        if opts.dilation_w_factor != 1 or opts.dilation_h_factor != 1:
            raise NotImplementedError(
                f"{what}: dilation "
                f"({opts.dilation_h_factor}, {opts.dilation_w_factor}) != 1 "
                "is not supported (compiling it would silently treat the "
                "kernel as dense)")

    for index, op in enumerate(sg.operators):
        code = tflite.BuiltinOperator(model.operator_codes[op.opcode_index].op)
        out_t = tensors[op.outputs[0]]
        out_q = _quant_info(out_t)
        out_shape = _per_sample(out_t.shape)

        if code == tflite.BuiltinOperator.FULLY_CONNECTED:
            in_t, w_t, b_t = (tensors[i] for i in op.inputs[:3])
            opts = op.fully_connected_options()
            if opts.keep_num_dims:
                raise NotImplementedError(
                    f"FULLY_CONNECTED #{index}: keep_num_dims is not "
                    "supported (the engine always flattens to 2D, matching "
                    "the reference's Tensor2D conversion)")
            # tflite stores FC weights [out, in]; runtime layout is [in, out]
            # (reference transposes at parse, macros/src/tensor.rs:98-114)
            weights = _tensor_data(model, w_t).T.copy()
            bias = _tensor_data(model, b_t).reshape(-1)
            in_q, w_q, bias_q = _quant_info(in_t), _quant_info(w_t), _quant_info(b_t)
            c0, c1, c2, c3 = folding.preprocess_fully_connected(
                in_q, w_q, bias, bias_q, out_q, weights
            )
            layers.append(
                FullyConnectedLayer(
                    index=index, weights=weights,
                    in_q=in_q, w_q=w_q, bias_q=bias_q, out_q=out_q,
                    c0=c0, c1=c1, c2=c2, c3=c3,
                    activation=_activation(opts.fused_activation_function),
                    flatten_input=len(in_t.shape) != 2,
                    out_shape=out_shape,
                )
            )

        elif code == tflite.BuiltinOperator.CONV_2D:
            in_t, w_t, b_t = (tensors[i] for i in op.inputs[:3])
            opts = op.conv_2d_options()
            _reject_dilation(opts, f"CONV_2D #{index}")
            filters = _tensor_data(model, w_t)  # [F, KH, KW, C]
            bias = _tensor_data(model, b_t).reshape(-1)
            in_q, w_q, bias_q = _quant_info(in_t), _quant_info(w_t), _quant_info(b_t)
            c0, c1 = folding.preprocess_conv_2d(in_q, w_q, bias, bias_q, out_q, filters.shape[0])
            geom = ViewGeometry(
                in_rows=in_t.shape[1], in_cols=in_t.shape[2],
                k_rows=filters.shape[1], k_cols=filters.shape[2],
                out_rows=out_t.shape[1], out_cols=out_t.shape[2],
                stride_rows=opts.stride_h, stride_cols=opts.stride_w,
                padding=_padding(opts.padding),
            )
            layers.append(
                Conv2DLayer(
                    index=index, filters=filters,
                    in_q=in_q, w_q=w_q, bias_q=bias_q, out_q=out_q,
                    c0=c0, c1=c1, geom=geom,
                    activation=_activation(opts.fused_activation_function),
                    out_shape=out_shape,
                )
            )

        elif code == tflite.BuiltinOperator.DEPTHWISE_CONV_2D:
            in_t, w_t, b_t = (tensors[i] for i in op.inputs[:3])
            opts = op.depthwise_conv_2d_options()
            _reject_dilation(opts, f"DEPTHWISE_CONV_2D #{index}")
            in_c, w_c = in_t.shape[3], w_t.shape[3]
            if in_c != 1 and in_c != w_c:
                # the supported fallback is the reference's: in_c == 1
                # (depth-multiplier stem, every output channel reads input
                # channel 0) or in_c == CH (true depthwise).  Anything else
                # would compile but diverge from TFLite semantics via the
                # reference's silent channel-0 fallback
                # (src/ops/depthwise_conv_2d.rs:92-99 ``unwrap_or``).
                raise NotImplementedError(
                    f"DEPTHWISE_CONV_2D #{index}: input channels {in_c} vs "
                    f"weight channels {w_c} (depth_multiplier="
                    f"{opts.depth_multiplier}) is outside the supported "
                    "fallback (in_c == 1 or in_c == weight channels)")
            weights = _tensor_data(model, w_t)[0]  # [KH, KW, CH]
            bias = _tensor_data(model, b_t).reshape(-1)
            in_q, w_q, bias_q = _quant_info(in_t), _quant_info(w_t), _quant_info(b_t)
            c0, c1 = folding.preprocess_depthwise_conv_2d(
                in_q, w_q, bias, bias_q, out_q, weights.shape[2]
            )
            geom = ViewGeometry(
                in_rows=in_t.shape[1], in_cols=in_t.shape[2],
                k_rows=weights.shape[0], k_cols=weights.shape[1],
                out_rows=out_t.shape[1], out_cols=out_t.shape[2],
                stride_rows=opts.stride_h, stride_cols=opts.stride_w,
                padding=_padding(opts.padding),
            )
            layers.append(
                DepthwiseConv2DLayer(
                    index=index, weights=weights,
                    in_q=in_q, w_q=w_q, bias_q=bias_q, out_q=out_q,
                    c0=c0, c1=c1, geom=geom,
                    activation=_activation(opts.fused_activation_function),
                    out_shape=out_shape,
                )
            )

        elif code == tflite.BuiltinOperator.AVERAGE_POOL_2D:
            in_t = tensors[op.inputs[0]]
            opts = op.pool_2d_options()
            in_q = _quant_info(in_t)
            c0, c1 = folding.preprocess_average_pool_2d(in_q, out_q)
            geom = ViewGeometry(
                in_rows=in_t.shape[1], in_cols=in_t.shape[2],
                k_rows=opts.filter_height, k_cols=opts.filter_width,
                out_rows=out_t.shape[1], out_cols=out_t.shape[2],
                stride_rows=opts.stride_h, stride_cols=opts.stride_w,
                padding=_padding(opts.padding),
            )
            layers.append(
                AveragePool2DLayer(
                    index=index, in_q=in_q, out_q=out_q, c0=c0, c1=c1, geom=geom,
                    activation=_activation(opts.fused_activation_function),
                    out_shape=out_shape,
                )
            )

        elif code == tflite.BuiltinOperator.SOFTMAX:
            in_t = tensors[op.inputs[0]]
            layers.append(
                SoftmaxLayer(
                    index=index, in_q=_quant_info(in_t), out_q=out_q, out_shape=out_shape
                )
            )

        elif code == tflite.BuiltinOperator.RESHAPE:
            layers.append(ReshapeLayer(index=index, out_shape=out_shape, out_q=out_q))

        elif code == tflite.BuiltinOperator.QUANTIZE:
            in_t = tensors[op.inputs[0]]
            layers.append(
                QuantizeLayer(
                    index=index,
                    in_q=_quant_info(in_t),
                    out_q=out_q,
                    out_dtype=np.dtype(out_t.type.np_dtype),
                    out_shape=out_shape,
                )
            )

        else:
            raise NotImplementedError(f"unsupported operator: {code!r}")

    return Graph(
        name=name or (sg.name or "model"),
        layers=layers,
        input_shape=_per_sample(inp.shape),
        input_q=_quant_info(inp),
        input_dtype=np.dtype(inp.type.np_dtype),
        output_shape=_per_sample(out.shape),
        output_q=_quant_info(out),
        output_dtype=np.dtype(out.type.np_dtype),
    )
