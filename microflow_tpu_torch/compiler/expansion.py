"""What a model's forward runs, op by op, without running it: the port's
counterpart of the JAX package's traced-program dump
(``CompiledModel.expansion``; the reference dumps its macro expansion to
``target/microflow-expansion.rs``).

For each layer, or each op of a whole-network kernel's plan, it gives the
shapes at the batch asked for and the function that computes it on the
model's device.  On CUDA that is the kernel's entry function, its source
and its path, by the rule each kernel module applies on shape alone
(``kernels/qgemm.py::qgemm_path``, ``kernels/qdwconv.py::plan``, the
whole-network kernels' ``paths``); on the CPU it is the plain torch
version that runs there.
"""

from __future__ import annotations

import numpy as np

from ..kernels.flatpack import INSTANTIATIONS
from ..kernels.qdwconv import PATH_GENERAL, PATH_NAMES
from ..kernels.qdwconv import plan as qdwconv_plan
from ..kernels.qgemm import MMA_MIN_K, qgemm_path
from .ir import (
    AddLayer,
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    QuantizeLayer,
    ReshapeLayer,
    SoftmaxLayer,
)

PLAIN_OPS = {FullyConnectedLayer: "ops.fully_connected", Conv2DLayer: "ops.conv_2d",
             DepthwiseConv2DLayer: "ops.depthwise_conv_2d",
             AveragePool2DLayer: "ops.average_pool_2d", SoftmaxLayer: "ops.softmax",
             ReshapeLayer: "ops.reshape", QuantizeLayer: "ops.quantize_op",
             AddLayer: "ops.add"}


def _dims(batch: int, shape) -> str:
    return "x".join(str(int(d)) for d in (batch, *shape))


def _qgemm(M: int, K: int, N: int, cuda: bool) -> str:
    if not cuda:
        return f"qgemm_reference [M={M}, K={K}, N={N}]"
    path = qgemm_path(M, K, N)
    entry = "qgemm_mma" if path == "mma" else "qgemm_rows" if K < MMA_MIN_K else "qgemm_kernel"
    return f"{entry} (csrc/qgemm.cu, path {path}) [M={M}, K={K}, N={N}]"


def _qdwconv(layer: DepthwiseConv2DLayer, batch: int, in_shape, cuda: bool) -> str:
    if not cuda:
        return "qdwconv_reference"
    g = layer.geom
    top, _, left, _ = g.pad_amounts()
    h, w, cin = in_shape
    p = qdwconv_plan(batch, h, w, cin, layer.weights.shape[2], kh=g.k_rows, kw=g.k_cols,
                     sr=g.stride_rows, sc=g.stride_cols, pad_top=top, pad_left=left,
                     oh=g.out_rows, ow=g.out_cols,
                     int8_taps=layer.weights.dtype == np.int8 and not np.any(layer.w_q.zero_point))
    entry = "qdwconv_general" if p.path == PATH_GENERAL else "qdwconv_tile"
    return f"{entry} (csrc/qdwconv.cu, path {PATH_NAMES[p.path]})"


def _function(layer, backend: str, cuda: bool, batch: int, in_shape) -> str:
    """What computes one layer run per op (``apply_layer``) on ``backend``."""
    if backend == "pallas":
        if isinstance(layer, FullyConnectedLayer):
            return _qgemm(batch, *layer.weights.shape, cuda)
        if isinstance(layer, Conv2DLayer):
            f, kh, kw, c = layer.filters.shape
            g = layer.geom
            return _qgemm(batch * g.out_rows * g.out_cols, kh * kw * c, f, cuda)
        if isinstance(layer, DepthwiseConv2DLayer):
            return _qdwconv(layer, batch, in_shape, cuda)
        if isinstance(layer, AddLayer):
            return "qadd_kernel (csrc/qadd.cu)" if cuda else "qadd_reference"
        if isinstance(layer, SoftmaxLayer):
            return "qsoftmax_kernel (csrc/qsoftmax.cu)" if cuda else "qsoftmax_reference"
    return PLAIN_OPS[type(layer)]


def _in_shapes(g) -> list[tuple]:
    """The per-sample shape of the (first) tensor each layer reads."""
    outs = [tuple(layer.out_shape) for layer in g.layers]
    if g.wiring is None:
        return [tuple(g.input_shape)] + outs[:-1]
    by_id = {g.wiring.input: tuple(g.input_shape)}
    by_id.update((out, shape) for (_, out), shape in zip(g.wiring.layers, outs))
    return [by_id[ins[0]] for ins, _ in g.wiring.layers]


def _layer_line(layer, batch: int, in_shape, what: str) -> str:
    name = type(layer).__name__.replace("Layer", "")
    return (f"  [{layer.index:>2}] {name:<16} {_dims(batch, in_shape):>14} -> "
            f"{_dims(batch, layer.out_shape):<14} {what}")


def _kernel_lines(entry: str, source: str, plain: str, cuda: bool, ops: list,
                  note: str = "") -> list[str]:
    """A whole-network kernel: a header naming what runs and one line an op,
    ``ops`` being ``(layer index, kind, in_shape, out_shape, path)``."""
    first, last = ops[0][0], ops[-1][0]
    span = f"layers {first}-{last}" if len(ops) > 1 else f"layer {first}"
    head = (f"{entry} ({source}{note}): {span} in one launch" if cuda
            else f"{plain} (the plain version of {entry}{note}): {span}")
    return [head] + [f"    layer {i:>2} {kind:<9} {tuple(a)} -> {tuple(b)}"
                     + (f"  {path}" if cuda and path else "") for i, kind, a, b, path in ops]


def expansion(model, batch_size: int = 1) -> str:
    """``CompiledModel.expansion``: the layer table, the backend and device,
    then what computes each layer or kernel op at ``batch_size``."""
    from ..utils.profiler import layer_table

    g = model.graph
    cuda = model.device.type == "cuda"
    b = batch_size
    shapes = _in_shapes(g)
    lines = [layer_table(g), "",
             f"backend: {model.backend}   device: {model.device}   batch: {b}", ""]

    def per_op(layers, backend):
        return [_layer_line(layer, b, shapes[layer.index], _function(
            layer, backend, cuda, b, shapes[layer.index])) for layer in layers]

    tail_from = len(g.layers)
    if model._flat is not None:
        fn, tail_from, _ = model._flat
        paths = fn.paths if cuda else [None] * len(fn.ops)
        lines += _kernel_lines(
            f"flat_kernel<{INSTANTIATIONS[fn.requant]}>", "csrc/flatpack.cu",
            "flat_forward_reference", cuda,
            [(op.layer_idx, op.kind, op.in_shape, op.out_shape, p)
             for op, p in zip(fn.ops, paths)], f", requant {fn.requant}")
    elif model._packed is not None:
        fn, tail_from, _ = model._packed
        lines += _kernel_lines(
            "packed_kernel", "csrc/packed.cu", "packed_reference", cuda,
            [(op.layer_idx, op.kind, op.in_shape, op.out_shape, p)
             for op, p in zip(fn.flat_ops, fn.paths)])
    elif model._colfc is not None:
        _, meta = model._colfc
        lines += _kernel_lines(
            "col_kernel", "csrc/colfc.cu", "colfc_reference",
            cuda, [(layer.index, "fc", shapes[layer.index], layer.out_shape, None)
                   for layer in g.layers], f", compute {meta['compute']}")
    elif model._fused_forward is not None:
        ff = model._fused_forward
        lines += per_op(ff.prefix, ff.prefix_backend)
        for kind, val in ff.steps:
            if kind == "reshape":
                lines.append(f"  reshape to {_dims(b, val)}")
                continue
            seg = val.segment
            lines += _kernel_lines(
                "segment_kernel", "csrc/megakernel.cu", "segment_reference", cuda,
                [(layer.index, type(layer).__name__.replace("Layer", ""), a, o, p)
                 for layer, (a, o), p in zip(seg.layers, seg.shapes, val.paths)])
        if ff.tail is not None:
            lines += per_op([ff.tail], "xla")
        return "\n".join(lines)
    else:
        tail_from = 0
    tail_backend = model.backend if tail_from == 0 else model._tail_backend
    lines += per_op(g.layers[tail_from:], tail_backend)
    return "\n".join(lines)
