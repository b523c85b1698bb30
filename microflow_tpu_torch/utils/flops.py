"""Static cost model: MACs and bytes per inference from the graph IR, as
``microflow_tpu.utils.flops`` counts them (the benchmark's MAC rate)."""

from __future__ import annotations

import numpy as np

from ..compiler.ir import (
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    Graph,
)


def layer_macs(layer) -> int:
    """Multiply-adds per sample of one layer (a pool's adds counted as
    MACs; reshape, softmax and quantize count 0)."""
    if isinstance(layer, FullyConnectedLayer):
        k, n = layer.weights.shape
        return int(k * n)
    if isinstance(layer, Conv2DLayer):
        f, kh, kw, c = layer.filters.shape
        return int(layer.geom.out_rows * layer.geom.out_cols * kh * kw * c * f)
    if isinstance(layer, DepthwiseConv2DLayer):
        kh, kw, ch = layer.weights.shape
        return int(layer.geom.out_rows * layer.geom.out_cols * kh * kw * ch)
    if isinstance(layer, AveragePool2DLayer):
        g = layer.geom
        return int(g.out_rows * g.out_cols * g.k_rows * g.k_cols)
    return 0


def macs_per_inference(graph: Graph) -> int:
    return sum(layer_macs(layer) for layer in graph.layers)


def activation_bytes_per_inference(graph: Graph) -> int:
    """int8 activation traffic (each layer output written once, read once)."""
    total = int(np.prod(graph.input_shape))
    for layer in graph.layers:
        total += int(np.prod(layer.out_shape))
    return 2 * total


def weight_bytes(graph: Graph) -> int:
    total = 0
    for layer in graph.layers:
        if isinstance(layer, (FullyConnectedLayer, DepthwiseConv2DLayer)):
            total += layer.weights.size
        elif isinstance(layer, Conv2DLayer):
            total += layer.filters.size
    return int(total)
