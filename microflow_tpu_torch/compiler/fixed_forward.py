"""Fixed-point-requant forward pass.

The counterpart of ``microflow_tpu.compiler.fixed_forward``: a forward that
runs every MAC op (FC / Conv2D / DWConv) with the (multiplier, right-shift)
integer requant of ``core/fixedpoint.py`` in place of the reference's f32
recipe.  Non-MAC ops (avgpool's mean rescale, softmax, QUANTIZE) keep the
exact float path: they are not accumulator requants.  The exact integer
accumulators are the plain ops' (``ops/``), on the params' device; the JAX
package runs no kernel here either.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.fixedpoint import derive_bias_q, quantize_multipliers, requant_fixed
from ..core.numerics import broadcast_per_channel
from ..core.tensor import reshape_2d
from ..ops.conv_2d import conv_2d_accumulate
from ..ops.depthwise_conv_2d import depthwise_conv_2d_accumulate
from .builder import apply_layer
from .ir import refuse_wiring
from .ir import Conv2DLayer, DepthwiseConv2DLayer, FullyConnectedLayer


def _requant(layer, p: dict, q: torch.Tensor, c1) -> torch.Tensor:
    m, s = quantize_multipliers(c1)
    return requant_fixed(q, derive_bias_q(p["c0"], c1), m, s, layer.out_q.zp0,
                         layer.activation, float(layer.out_q.scale0))


def _fc_fixed(layer: FullyConnectedLayer, p: dict, x: torch.Tensor) -> torch.Tensor:
    if layer.flatten_input:
        x = reshape_2d(x)
    x64 = x.to(torch.float64)
    acc = x64 @ p["weights"].to(torch.float64)  # exact, as the plain FC
    if layer.w_q.zp0 != 0:
        acc = acc - x64.sum(dim=1, keepdim=True) * float(layer.w_q.zp0)
    q = acc - p["c2"].to(torch.float64)[None, :] + float(layer.c3)
    return _requant(layer, p, q, layer.c1)


def _conv_fixed(layer: Conv2DLayer, p: dict, x: torch.Tensor) -> torch.Tensor:
    nf = layer.filters.shape[0]
    w_zp = broadcast_per_channel(layer.w_q.zero_point, nf, np.int32)
    q = conv_2d_accumulate(x, p["weights"], layer.geom, layer.in_q.zp0, w_zp)
    return _requant(layer, p, q, broadcast_per_channel(layer.c1, nf, np.float32))


def _dwconv_fixed(layer: DepthwiseConv2DLayer, p: dict, x: torch.Tensor) -> torch.Tensor:
    ch = layer.weights.shape[2]
    w_zp = broadcast_per_channel(layer.w_q.zero_point, ch, np.int32)
    in_c = x.shape[-1]
    if in_c != ch:  # the depth-multiplier fallback: missing channels read channel 0
        x = x[..., [c if c < in_c else 0 for c in range(ch)]]
    q = depthwise_conv_2d_accumulate(x, p["weights"], layer.geom, layer.in_q.zp0, w_zp)
    return _requant(layer, p, q, broadcast_per_channel(layer.c1, ch, np.float32))


def build_fixed_forward(graph):
    """``forward(params, xq) -> yq`` with fixed-point MAC requants;
    ``params`` as ``CompiledModel.params`` holds them."""
    refuse_wiring(graph, "the fixed-point forward")
    # requant_fixed saturates to the int8 range; a uint8 graph would
    # silently produce wrong-range outputs, so refuse it up front.
    if np.dtype(graph.input_dtype) != np.int8:
        raise NotImplementedError(
            f"fixed-point forward supports int8 graphs only, got {graph.input_dtype}")

    def forward(params: dict, xq: torch.Tensor) -> torch.Tensor:
        x = xq
        for layer in graph.layers:
            p = params.get(f"layer{layer.index}")
            if isinstance(layer, FullyConnectedLayer):
                x = _fc_fixed(layer, p, x)
            elif isinstance(layer, Conv2DLayer):
                x = _conv_fixed(layer, p, x)
            elif isinstance(layer, DepthwiseConv2DLayer):
                x = _dwconv_fixed(layer, p, x)
            else:
                x = apply_layer(layer, params, x, "xla")
        return x

    return forward
