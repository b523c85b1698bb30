"""TFLite graph front-end: flatbuffer -> folded static Graph IR.

The equivalent of the reference's proc-macro entry point
(``microflow-macros/src/lib.rs:46-183``): reads subgraph 0, dispatches the
supported builtin operators, decodes weight buffers, folds the
requantization constants, and emits ``compiler.ir`` layer records.  The
port of ``microflow_tpu.frontend.parser``, with both of its readers: the
native C++ parser (``native/``, through ``native_backend.py``) and the
Python flatbuffer reader (``tflite.py``), its oracle.
"""

from __future__ import annotations

import numpy as np

from ..compiler import folding
from ..compiler.ir import (
    AddLayer,
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    Graph,
    QuantInfo,
    QuantizeLayer,
    ReshapeLayer,
    SoftmaxLayer,
    Wiring,
    chain_length,
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


FRONTENDS = ("auto", "native", "python")


def _load(path: str, frontend: str):
    """The model's flatbuffer through the reader ``frontend`` names."""
    if frontend not in FRONTENDS:
        raise ValueError(f"unknown frontend {frontend!r}; choose one of {FRONTENDS}")
    if frontend == "python":
        return tflite.load_model(path)
    from . import native_backend

    if frontend == "native":
        return native_backend.load_model(path)  # raises with the build error
    try:
        return native_backend.load_model(path)
    except (RuntimeError, ValueError):
        # no library (g++ missing or failing), or the C++ reader refused the
        # bytes: the Python reader decides, and its error is the one raised
        return tflite.load_model(path)


def parse(path: str, name: str | None = None, frontend: str = "auto") -> Graph:
    """Parse and fold the ``.tflite`` model at ``path``.

    ``frontend`` is ``"auto"`` (the default, as in the JAX package), the
    native C++ parser with the Python reader as the fallback, where the
    library cannot be built or refuses the bytes; ``"native"``, which
    raises ``RuntimeError`` with the build error where there is no library;
    or ``"python"``.  Both readers give the same graph, bit for bit.  The
    fallback is the host front end's, as in the JAX package: the graph is
    the same whichever reader made it, and no device or kernel is involved.
    The fold (``compiler/folding.py``) takes the native ``mf_fold_*`` when
    the library loads, whatever the reader.
    """
    model = _load(path, frontend)
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

    wiring = []  # (data input ids, output id) a layer
    written = {sg.inputs[0]}
    for index, op in enumerate(sg.operators):
        code = tflite.BuiltinOperator(model.operator_codes[op.opcode_index].op)
        out_t = tensors[op.outputs[0]]
        out_q = _quant_info(out_t)
        out_shape = _per_sample(out_t.shape)
        reads = tuple(op.inputs[:2] if code == tflite.BuiltinOperator.ADD else op.inputs[:1])
        for t in reads:
            if t not in written:
                raise NotImplementedError(
                    f"{code.name} #{index}: input tensor {t} is neither the graph's input "
                    "nor the output of an earlier operator")
        written.add(op.outputs[0])
        wiring.append((reads, op.outputs[0]))

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

        elif code == tflite.BuiltinOperator.ADD:
            in1_t, in2_t = tensors[op.inputs[0]], tensors[op.inputs[1]]
            if in1_t.shape != in2_t.shape or in1_t.shape != out_t.shape:
                raise NotImplementedError(
                    f"ADD #{index}: shapes {in1_t.shape} + {in2_t.shape} -> {out_t.shape}; "
                    "only an elementwise ADD of one shape is supported (no broadcast)")
            types = {in1_t.type, in2_t.type, out_t.type}
            if types != {tflite.TensorType.INT8}:
                raise NotImplementedError(
                    f"ADD #{index}: tensor types {sorted(t.name for t in types)}; only int8 "
                    "is supported")
            in1_q, in2_q = _quant_info(in1_t), _quant_info(in2_t)
            act = _activation(op.add_options().fused_activation_function)
            layers.append(
                AddLayer(
                    index=index, in1_q=in1_q, in2_q=in2_q, out_q=out_q,
                    **folding.preprocess_add(in1_q, in2_q, out_q, act),
                    activation=act, out_shape=out_shape,
                )
            )

        else:
            raise NotImplementedError(f"unsupported operator: {code!r}")

    graph = Graph(
        name=name or (sg.name or "model"),
        layers=layers,
        input_shape=_per_sample(inp.shape),
        input_q=_quant_info(inp),
        input_dtype=np.dtype(inp.type.np_dtype),
        output_shape=_per_sample(out.shape),
        output_q=_quant_info(out),
        output_dtype=np.dtype(out.type.np_dtype),
        wiring=Wiring(sg.inputs[0], sg.outputs[0], tuple(wiring)),
    )
    if wiring and wiring[-1][1] != sg.outputs[0]:
        raise NotImplementedError(
            f"the graph's output is tensor {sg.outputs[0]}, not the last operator's "
            f"({wiring[-1][1]})")
    if chain_length(graph) == len(layers):
        graph.wiring = None  # a chain, as every graph without an ADD is
    return graph
