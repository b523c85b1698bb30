"""Graph builder: folded IR -> batched torch model.

The counterpart of ``microflow_tpu.compiler.builder``.  Where the JAX
package closes a jitted function over the layer IR, the port runs the
layers eagerly: static attributes (shapes, strides, folded scalars,
quantization parameters) are host values, and the trainable arrays
(weights, C0 bias constants, FC's derived C2) are torch tensors on the
model's device in ``CompiledModel.params``, which may be swapped.

The API mirrors the reference model struct:

* ``predict(x_f32)            -> f32``   (quantize -> layers -> dequantize)
* ``predict_quantized(x_int)  -> f32``
* ``predict_inner(x_int)      -> int``   (the raw quantized pipeline)

Backends (the JAX package's names, so callers pass the same strings):

* ``"xla"`` -- the plain torch ops of ``ops/``: exact integer contractions
  in float64 or int32 and the reference's f32 epilogues.  The oracle.
* ``"pallas"`` -- FullyConnected and Conv2D through the ``qgemm`` kernel,
  DepthwiseConv2D through ``qdwconv`` (hand-written CUDA for Hopper); pool,
  reshape, softmax and quantize stay plain torch, as they are plain array
  ops in the JAX package's per-op backend.  int8 graphs only.  On the CPU
  the kernels' plain versions run instead, which keeps the host-side prep
  (im2col, folded ``d``, centred weights, padding, channel gather) tested.
* ``"auto"`` -- ``"pallas"`` on CUDA, ``"xla"`` on the CPU.
* ``"flat"`` and the experimental ``"fused"``, ``"hybrid"``, ``"packed"``,
  ``"colfc"`` -- not ported yet (ROADMAP.md, queue B); they raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.numerics import const_f32, f32, torch_dtype
from ..core.quantize import dequantize, quantize
from ..core.tensor import pad_nhwc, reshape_2d
from ..ops import (
    average_pool_2d,
    conv_2d,
    depthwise_conv_2d,
    fully_connected,
    quantize_op,
    reshape,
    softmax,
)
from ..ops.conv_2d import im2col
from .ir import (
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    Graph,
    QuantizeLayer,
    ReshapeLayer,
    SoftmaxLayer,
)

BACKENDS = frozenset({"auto", "xla", "pallas"})
# The JAX package's other backends, still to port (ROADMAP.md queue B).
UNPORTED_BACKENDS = frozenset({"flat", "fused", "hybrid", "packed", "colfc"})


def _broadcast_per_channel(values: np.ndarray, n: int, dtype) -> np.ndarray:
    """Reference ``.get(i).unwrap_or(arr[0])`` as a static broadcast."""
    return np.array([values[i] if i < len(values) else values[0] for i in range(n)], dtype)


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  CUDA that is absent raises: the port never
    carries on quietly on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's plain "
            "torch versions on the CPU")
    return device


def params_from_numpy(params: dict, device=None) -> dict:
    """``{"layerN": {"weights", "c0", "c2"?}}`` of numpy arrays (or anything
    ``np.asarray`` takes, such as the JAX package's ``init_params`` pytree)
    -> the same dict of torch tensors on ``device``."""
    device = resolve_device(device)
    return {
        layer: {k: torch.as_tensor(np.array(v), device=device) for k, v in arrays.items()}
        for layer, arrays in params.items()
    }


def init_params(graph: Graph, device=None) -> dict:
    """Trainable/updatable tensors, keyed by layer index."""
    params = {}
    for layer in graph.layers:
        if isinstance(layer, FullyConnectedLayer):
            params[f"layer{layer.index}"] = {
                "weights": layer.weights, "c0": layer.c0, "c2": layer.c2}
        elif isinstance(layer, Conv2DLayer):
            params[f"layer{layer.index}"] = {"weights": layer.filters, "c0": layer.c0}
        elif isinstance(layer, DepthwiseConv2DLayer):
            params[f"layer{layer.index}"] = {"weights": layer.weights, "c0": layer.c0}
    return params_from_numpy(params, device)


def _i32(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.int32), device=device)


def layer_constants(layer, device) -> dict:
    """Per-layer constants of the kernel path as tensors on ``device``.

    ``CompiledModel`` makes them once: a host-to-device copy from pageable
    memory waits for the stream, so making them inside the forward would
    leave the card idle at every layer.
    """
    if isinstance(layer, FullyConnectedLayer):
        n = layer.weights.shape[1]
        return {"wzp": _i32(np.full(n, layer.w_q.zp0), device),
                "c1": const_f32(np.full(n, layer.c1), device)}
    if isinstance(layer, Conv2DLayer):
        n = layer.filters.shape[0]
    elif isinstance(layer, DepthwiseConv2DLayer):
        n = layer.weights.shape[2]
    else:
        return {}
    return {"wzp": _i32(_broadcast_per_channel(layer.w_q.zero_point, n, np.int32), device),
            "c1": const_f32(_broadcast_per_channel(layer.c1, n, np.float32), device)}


def _bias0(layer, p: dict) -> torch.Tensor:
    """``f32(out_zp) + c0`` on the params' device (an exact f32 add)."""
    return f32(p["c0"]) + float(layer.out_q.zp0)


def _fc_kernel(layer: FullyConnectedLayer, p: dict, x: torch.Tensor, k: dict) -> torch.Tensor:
    from ..kernels import qgemm

    return qgemm(
        x.contiguous(),
        p["weights"].contiguous(),
        k["wzp"],
        (int(layer.c3) - p["c2"].to(torch.int32)).contiguous(),
        _bias0(layer, p),
        k["c1"],
        activation=layer.activation,
        out_scale=float(layer.out_q.scale0),
        out_zp=layer.out_q.zp0,
    )


def _conv_kernel(layer: Conv2DLayer, p: dict, x: torch.Tensor, k: dict) -> torch.Tensor:
    from ..kernels import qgemm

    geom = layer.geom
    in_zp = layer.in_q.zp0
    num_f = layer.filters.shape[0]
    xg = im2col(x, geom, in_zp).contiguous()  # [B*OH*OW, K]
    kk = xg.shape[1]
    wg = p["weights"].reshape(num_f, kk).T.contiguous()  # [K, F]
    colsum = wg.to(torch.int32).sum(dim=0, dtype=torch.int32)
    d = (kk * in_zp) * k["wzp"] - in_zp * colsum
    y = qgemm(
        xg, wg, k["wzp"], d.to(torch.int32), _bias0(layer, p), k["c1"],
        activation=layer.activation,
        out_scale=float(layer.out_q.scale0),
        out_zp=layer.out_q.zp0,
    )
    return y.reshape(x.shape[0], geom.out_rows, geom.out_cols, num_f)


def _dw_kernel(layer: DepthwiseConv2DLayer, p: dict, x: torch.Tensor, k: dict) -> torch.Tensor:
    from ..kernels import qdwconv

    geom = layer.geom
    in_zp = layer.in_q.zp0
    ch = layer.weights.shape[2]
    if x.shape[-1] != ch:
        # the depth-multiplier stem (the parser admits no other channel
        # mismatch): every channel reads input channel 0; the padding copy
        # below materialises the broadcast
        x = x.expand(*x.shape[:-1], ch)
    xp = pad_nhwc(x, geom, in_zp).contiguous()
    wc = (p["weights"].to(torch.int32) - k["wzp"][None, None, :]).contiguous()
    d = (-in_zp) * wc.sum(dim=(0, 1), dtype=torch.int32)
    return qdwconv(
        xp, wc, d.to(torch.int32), _bias0(layer, p), k["c1"],
        kh=geom.k_rows, kw=geom.k_cols,
        sr=geom.stride_rows, sc=geom.stride_cols,
        oh=geom.out_rows, ow=geom.out_cols,
        activation=layer.activation,
        out_scale=float(layer.out_q.scale0),
        out_zp=layer.out_q.zp0,
    )


def apply_layer(layer, params: dict, x: torch.Tensor, backend: str = "xla",
                consts: dict | None = None) -> torch.Tensor:
    """Run one IR layer.  ``backend="xla"`` uses the plain torch ops;
    ``backend="pallas"`` routes FC / Conv / DWConv through the kernels
    (identical numerics), with the layer's ``layer_constants`` (made here
    when not given)."""
    kernels = backend == "pallas"
    if kernels and consts is None:
        consts = layer_constants(layer, x.device)
    if isinstance(layer, FullyConnectedLayer):
        if layer.flatten_input:
            x = reshape_2d(x)
        p = params[f"layer{layer.index}"]
        if kernels:
            return _fc_kernel(layer, p, x, consts)
        return fully_connected(
            x,
            p["weights"],
            w_zp=layer.w_q.zp0,
            bias0=_bias0(layer, p),
            c1=layer.c1,
            c2=p["c2"],
            c3=layer.c3,
            out_scale=layer.out_q.scale0,
            out_zp=layer.out_q.zp0,
            activation=layer.activation,
        )
    if isinstance(layer, Conv2DLayer):
        p = params[f"layer{layer.index}"]
        if kernels:
            return _conv_kernel(layer, p, x, consts)
        num_f = layer.filters.shape[0]
        w_zp = _broadcast_per_channel(layer.w_q.zero_point, num_f, np.int32)
        c1 = _broadcast_per_channel(layer.c1, num_f, np.float32)
        return conv_2d(
            x,
            p["weights"],
            geom=layer.geom,
            in_zp=layer.in_q.zp0,
            w_zp=w_zp,
            bias0=_bias0(layer, p),
            c1=c1,
            out_scale=layer.out_q.scale0,
            out_zp=layer.out_q.zp0,
            activation=layer.activation,
        )
    if isinstance(layer, DepthwiseConv2DLayer):
        p = params[f"layer{layer.index}"]
        if kernels:
            return _dw_kernel(layer, p, x, consts)
        ch = layer.weights.shape[2]
        w_zp = _broadcast_per_channel(layer.w_q.zero_point, ch, np.int32)
        c1 = _broadcast_per_channel(layer.c1, ch, np.float32)
        return depthwise_conv_2d(
            x,
            p["weights"],
            geom=layer.geom,
            in_zp=layer.in_q.zp0,
            w_zp=w_zp,
            bias0=_bias0(layer, p),
            c1=c1,
            out_scale=layer.out_q.scale0,
            out_zp=layer.out_q.zp0,
            activation=layer.activation,
        )
    if isinstance(layer, AveragePool2DLayer):
        return average_pool_2d(
            x,
            geom=layer.geom,
            c0=layer.c0,
            c1=layer.c1,
            out_scale=layer.out_q.scale0,
            out_zp=layer.out_q.zp0,
            activation=layer.activation,
        )
    if isinstance(layer, SoftmaxLayer):
        if x.dim() > 2:
            x = reshape_2d(x)
        return softmax(
            x,
            in_scale=layer.in_q.scale0,
            out_scale=layer.out_q.scale0,
            out_zp=layer.out_q.zp0,
        )
    if isinstance(layer, ReshapeLayer):
        return reshape(x, layer.out_shape)
    if isinstance(layer, QuantizeLayer):
        return quantize_op(
            x,
            in_scale=layer.in_q.scale0,
            in_zp=layer.in_q.zp0,
            out_scale=layer.out_q.scale0,
            out_zp=layer.out_q.zp0,
            out_dtype=torch_dtype(layer.out_dtype),
        )
    raise TypeError(f"unknown layer {type(layer)}")


def _check_int8(graph: Graph) -> None:
    """The kernels take int8 only: refuse any other activation or weight
    type on the kernel backend."""
    dtypes = {np.dtype(graph.input_dtype)}
    for layer in graph.layers:
        for arr in (getattr(layer, "weights", None), getattr(layer, "filters", None)):
            if arr is not None:
                dtypes.add(arr.dtype)
        if isinstance(layer, QuantizeLayer):
            dtypes.add(np.dtype(layer.out_dtype))
    bad = sorted(str(d) for d in dtypes if d != np.int8)
    if bad:
        raise ValueError(
            f"backend 'pallas' runs int8 graphs only; {graph.name!r} has {bad} "
            "tensors (use backend='xla')")


class CompiledModel:
    """The built model: batched, eager, params as a dict of tensors on
    ``device``."""

    def __init__(self, graph: Graph, backend: str = "auto", device=None):
        self.graph = graph
        self.device = resolve_device(device)
        if backend in UNPORTED_BACKENDS:
            raise NotImplementedError(
                f"backend {backend!r} is not ported to torch yet; see ROADMAP.md "
                "(queue B). Ported: 'xla', 'pallas', 'auto'")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose one of {sorted(BACKENDS)}")
        if backend == "auto":
            backend = "pallas" if self.device.type == "cuda" else "xla"
        if backend == "pallas":
            _check_int8(graph)
        self.backend = backend
        self.params = init_params(graph, self.device)
        self._consts = ({layer.index: layer_constants(layer, self.device)
                         for layer in graph.layers} if backend == "pallas" else {})

    def _forward(self, xq: torch.Tensor) -> torch.Tensor:
        for layer in self.graph.layers:
            xq = apply_layer(layer, self.params, xq, self.backend, self._consts.get(layer.index))
        return xq

    def _input(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(dtype)

    # --- public API (mirrors the reference generated model struct) ---

    def quantize_input(self, x) -> torch.Tensor:
        g = self.graph
        return quantize(self._input(x, torch.float32), g.input_q.scale0, g.input_q.zp0,
                        dtype=torch_dtype(g.input_dtype))

    def warm(self, batch_size: int) -> None:
        """Build the kernels and run one zero batch of ``batch_size`` so
        later calls pay no first-use cost."""
        xq = torch.zeros((batch_size, *self.graph.input_shape),
                         dtype=torch_dtype(self.graph.input_dtype), device=self.device)
        self._forward(xq)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, x) -> torch.Tensor:
        """f32 [B, *input_shape] -> f32 [B, *output_shape]."""
        return self.predict_quantized(self.quantize_input(x))

    def predict_quantized(self, xq) -> torch.Tensor:
        """int [B, *input_shape] -> f32 [B, *output_shape]."""
        yq = self.predict_inner(xq)
        return dequantize(yq, self.graph.output_q.scale0, self.graph.output_q.zp0)

    def predict_inner(self, xq) -> torch.Tensor:
        """int [B, *input_shape] -> int [B, *output_shape]."""
        return self._forward(self._input(xq, torch_dtype(self.graph.input_dtype)))


def build(graph: Graph, backend: str = "auto", device=None) -> CompiledModel:
    return CompiledModel(graph, backend=backend, device=device)


def compile_tflite(path: str, name: str | None = None, backend: str = "auto",
                   device=None) -> CompiledModel:
    """One-call front door: ``.tflite`` path -> compiled batched model on
    ``device`` (default CUDA; raises if CUDA is absent)."""
    from ..frontend.parser import parse

    device = resolve_device(device)
    return build(parse(path, name=name), backend=backend, device=device)
