"""The yardstick's arithmetic: MACs and bytes of one inference from the
configuration's graph, and the published peaks of the card.

The MAC and byte counts are the benchmark's frozen copy of the arithmetic
of the program's ``utils/flops.py``, applied to the graph that the
configuration's plain reference parses (``harness.reference_of``), so that
they read the same work whatever backend implements it.  Whichever
reference package parsed the graph, each layer that the frozen IR classes
of ``reference/compiler/ir.py`` describe is an instance of that class, and
is counted by the rules below; a layer of any other kind has an
``out_shape``, which counts as activation bytes, and counts 0 MACs and 0
weight bytes.
"""

from __future__ import annotations

import numpy as np

from .reference.compiler.ir import (
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
)

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
PEAK_INT8_OPS_PER_S = 1.979e15
PEAK_HBM_BYTES_PER_S = 3.35e12


def layer_macs(layer) -> int:
    """Multiply-adds per sample of one layer (a pool's adds counted as
    MACs; reshape, softmax, quantize and any layer kind the frozen IR does
    not describe count 0)."""
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


def macs_per_inference(graph) -> int:
    return sum(layer_macs(layer) for layer in graph.layers)


def activation_bytes_per_inference(graph) -> int:
    """int8 activation traffic (each layer output written once, read once)."""
    total = int(np.prod(graph.input_shape))
    for layer in graph.layers:
        total += int(np.prod(layer.out_shape))
    return 2 * total


def weight_bytes(graph) -> int:
    total = 0
    for layer in graph.layers:
        if isinstance(layer, (FullyConnectedLayer, DepthwiseConv2DLayer)):
            total += layer.weights.size
        elif isinstance(layer, Conv2DLayer):
            total += layer.filters.size
    return int(total)


def io_bytes_per_inference(graph) -> int:
    """One sample's int8 input read and output written, once each."""
    return int(np.prod(graph.input_shape)) + int(np.prod(graph.output_shape))


def least_forward_seconds(graph, batch: int) -> float:
    """The least time the card could take for a forward of ``batch``
    samples: the larger of 2 * MACs over the int8 peak and the input,
    output and weight bytes, each counted once, over the HBM bandwidth."""
    ops = 2.0 * macs_per_inference(graph) * batch
    moved = io_bytes_per_inference(graph) * batch + weight_bytes(graph)
    return max(ops / PEAK_INT8_OPS_PER_S, moved / PEAK_HBM_BYTES_PER_S)
