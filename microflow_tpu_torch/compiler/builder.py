"""Graph builder: folded IR -> batched torch model.

The counterpart of ``microflow_tpu.compiler.builder``.  Where the JAX
package closes a jitted function over the layer IR, the port runs the
layers eagerly: static attributes (shapes, strides, folded scalars,
quantization parameters) are host values, and the trainable arrays
(weights, C0 bias constants, FC's derived C2) are torch tensors on the
model's device in ``CompiledModel.params``.  The per-op backends
(``"xla"``, ``"pallas"``) compute from ``params``, which may be swapped; the
whole-network backends (``"flat"``, ``"colfc"``, ``"fused"``, ``"hybrid"``,
``"packed"``) bake the weights into their kernels' plans at build and
refuse a swap (the JAX package re-plans ``fused``/``hybrid`` from
``params`` on every call).

The API mirrors the reference model struct:

* ``predict(x_f32)            -> f32``   (quantize -> layers -> dequantize)
* ``predict_quantized(x_int)  -> f32``
* ``predict_inner(x_int)      -> int``   (the raw quantized pipeline)

Backends (the JAX package's names, so callers pass the same strings):

* ``"xla"`` -- the plain torch ops of ``ops/``: exact integer contractions
  in float64 or int32 and the reference's f32 epilogues.  The oracle.
* ``"flat"`` -- the whole flat-packable prefix of the graph in one
  hand-written CUDA kernel (``kernels/flatpack.py``), the JAX package's
  production path; the layers after the prefix (none for the bundled
  models) run as ``"pallas"`` on CUDA and as the plain ops on the CPU.
  Like the JAX package's, the kernel reads weights baked into its plan at
  build.  int8 graphs only.  ``MFT_FLAT_REQUANT`` picks its epilogue, as
  in the JAX package: ``exact2`` (the default), ``exact`` or ``fixed`` (the
  integer (M, S) requant of ``core/fixedpoint.py``).  Where the plan refuses
  ``fixed`` (some ``d + bias_q`` leaves int32), ``"flat"`` and ``"auto"``
  raise ``ValueError``; the JAX package's ``"auto"`` falls back to XLA.
* ``"pallas"`` -- FullyConnected and Conv2D through the ``qgemm`` kernel,
  DepthwiseConv2D through ``qdwconv``, ADD through ``qadd``, Softmax
  through ``qsoftmax`` (hand-written CUDA for Hopper); pool, reshape and
  quantize stay plain torch, as they are plain array ops in the JAX
  package's per-op backend.  int8 graphs only.  On the CPU
  the kernels' plain versions run instead, which keeps the host-side prep
  (im2col, folded ``d``, centred weights, padding, channel gather) tested.
* ``"colfc"`` -- the JAX package's experimental column-FC kernel for tiny
  FullyConnected chains (``kernels/colfc.py``), weights baked at build.
  int8 graphs only.
* ``"auto"`` -- ``resolve_backend``: on CUDA, ``"flat"`` for a graph with a
  Conv2D/DepthwiseConv2D layer that flat-packs (as the JAX package picks
  on its accelerator), else ``"pallas"``; ``"xla"`` on the CPU.  A
  non-int8 graph on CUDA raises: it runs only where the caller asks for
  ``"xla"``.
* ``"fused"`` -- the JAX package's experimental megakernel
  (``kernels/megakernel.py``): the graph split into segments at each
  reshape and flattening FullyConnected, one launch of ``csrc/megakernel.cu``
  per segment (person_detect: 1 a forward, layers 0-28; speech: 2; sine:
  1), the trailing softmax as the plain op.  Fusable int8 graphs only.
* ``"hybrid"`` -- ``"fused"`` from ``hybrid_split_index`` on (the first
  layer whose input has at least 64 channels: person_detect 9, speech 0,
  sine 3, i.e. no segment); the layers before it run as ``"pallas"`` on
  CUDA (person_detect: 5 ``qdwconv`` and 4 ``qgemm`` launches a forward)
  and as the plain ops on the CPU, as the JAX package runs them through XLA.
* ``"packed"`` -- the JAX package's experimental packed pipeline
  (``kernels/packed.py``): the depthwise/pointwise prefix in one launch of
  ``csrc/packed.cu`` (person_detect layers 0-22), the tail as the flat
  tail (on CUDA 2 ``qdwconv`` and 3 ``qgemm`` launches a forward, then the
  plain pool, reshape and softmax).  A graph that does not pack (sine,
  speech) raises ``ValueError``.

``"auto"`` never picks ``"fused"``, ``"hybrid"`` or ``"packed"``, as in the
JAX package.  ``backend=None`` is ``default_backend()``: the environment's
``MFT_BACKEND``, else ``"auto"``, as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.numerics import as_device, broadcast_per_channel, const_f32, f32, torch_dtype
from ..core.quantize import dequantize, quantize
from ..core.tensor import reshape_2d
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
from ..utils import trace
from .ir import (
    AddLayer,
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    Graph,
    QuantizeLayer,
    ReshapeLayer,
    SoftmaxLayer,
)

BACKENDS = frozenset({"auto", "xla", "pallas", "flat", "colfc", "fused", "hybrid", "packed"})
# the backends whose kernels read weights baked in at build: they refuse a
# ``params`` swap (``CompiledModel.params``) and cannot train
BAKED_BACKENDS = frozenset({"flat", "colfc", "fused", "hybrid", "packed"})
# PyTorch's caching allocator serves a request of at most 1 MiB from 2 MiB
# segments.  An output of more than half of that, kept by a caller that keeps
# every batch's output on the card (an offline scoring loop), then takes a new
# segment every second call, and the card's queue drains at each (MobileNetV2's
# 1024 x 1001 outputs: 1.2-5.5% of the rate, most of its run-to-run spread).
# ``keepable`` moves such an output into a block just past 1 MiB, which the
# allocator carves from its 20 MiB segments.
SMALL_POOL_MAX = 1 << 20


def default_backend() -> str:
    """The backend that ``backend=None`` means: ``MFT_BACKEND`` if it is
    set, else ``"auto"``."""
    backend = os.environ.get("MFT_BACKEND", "auto")
    if backend not in BACKENDS:
        raise ValueError(f"MFT_BACKEND={backend!r} is not a known backend; "
                         f"choose one of {sorted(BACKENDS)}")
    return backend


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
        layer: {k: as_device(np.array(v), device) for k, v in arrays.items()}
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
    return as_device(np.asarray(values, np.int32), device)


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
    return {"wzp": _i32(broadcast_per_channel(layer.w_q.zero_point, n, np.int32), device),
            "c1": const_f32(broadcast_per_channel(layer.c1, n, np.float32), device)}


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


def conv_folds(layer: Conv2DLayer, p: dict, k: dict) -> dict:
    """The weight-dependent operands of ``_conv_kernel``: the weights as the
    GEMM's [K, F] operand ``w``, the folded zero-point correction ``d`` and
    ``bias0``."""
    in_zp = layer.in_q.zp0
    num_f = layer.filters.shape[0]
    kk = int(np.prod(layer.filters.shape[1:]))
    wg = p["weights"].reshape(num_f, kk).T.contiguous()  # [K, F]
    colsum = wg.to(torch.int32).sum(dim=0, dtype=torch.int32)
    d = (kk * in_zp) * k["wzp"] - in_zp * colsum
    return {"w": wg, "d": d.to(torch.int32), "bias0": _bias0(layer, p)}


def dw_folds(layer: DepthwiseConv2DLayer, p: dict, k: dict) -> dict:
    """The weight-dependent operands of ``_dw_kernel``: the centred taps
    ``wc``, ``d`` and ``bias0``."""
    wc = (p["weights"].to(torch.int32) - k["wzp"][None, None, :]).contiguous()
    d = (-layer.in_q.zp0) * wc.sum(dim=(0, 1), dtype=torch.int32)
    return {"wc": wc, "d": d.to(torch.int32), "bias0": _bias0(layer, p)}


def _conv_kernel(layer: Conv2DLayer, p: dict, x: torch.Tensor, k: dict,
                 f: dict | None = None) -> torch.Tensor:
    from ..kernels import qgemm

    geom = layer.geom
    xg = im2col(x, geom, layer.in_q.zp0).contiguous()  # [B*OH*OW, K]
    f = conv_folds(layer, p, k) if f is None else f
    y = qgemm(
        xg, f["w"], k["wzp"], f["d"], f["bias0"], k["c1"],
        activation=layer.activation,
        out_scale=float(layer.out_q.scale0),
        out_zp=layer.out_q.zp0,
    )
    return y.reshape(x.shape[0], geom.out_rows, geom.out_cols, layer.filters.shape[0])


def _dw_kernel(layer: DepthwiseConv2DLayer, p: dict, x: torch.Tensor, k: dict,
               f: dict | None = None) -> torch.Tensor:
    from ..kernels import qdwconv

    geom = layer.geom
    in_zp = layer.in_q.zp0
    # x has the weights' channels or one (the depth-multiplier stem; the
    # parser admits no other mismatch): the kernel reads it unpadded
    top, _, left, _ = geom.pad_amounts()
    f = dw_folds(layer, p, k) if f is None else f
    return qdwconv(
        x.contiguous(), f["wc"], f["d"], f["bias0"], k["c1"],
        in_zp=in_zp, pad_top=top, pad_left=left,
        int8_taps=p["weights"].dtype == torch.int8 and not np.any(layer.w_q.zero_point),
        kh=geom.k_rows, kw=geom.k_cols,
        sr=geom.stride_rows, sc=geom.stride_cols,
        oh=geom.out_rows, ow=geom.out_cols,
        activation=layer.activation,
        out_scale=float(layer.out_q.scale0),
        out_zp=layer.out_q.zp0,
    )


def apply_layer(layer, params: dict, x: torch.Tensor, backend: str = "xla",
                consts: dict | None = None, folds: dict | None = None) -> torch.Tensor:
    """Run one IR layer.  ``backend="xla"`` uses the plain torch ops;
    ``backend="pallas"`` routes FC / Conv / DWConv through the kernels
    (identical numerics), with the layer's ``layer_constants`` (made here
    when not given) and a conv's or depthwise layer's ``conv_folds`` or
    ``dw_folds`` of ``params`` (made here when not given)."""
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
            return _conv_kernel(layer, p, x, consts, folds)
        num_f = layer.filters.shape[0]
        w_zp = broadcast_per_channel(layer.w_q.zero_point, num_f, np.int32)
        c1 = broadcast_per_channel(layer.c1, num_f, np.float32)
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
            return _dw_kernel(layer, p, x, consts, folds)
        ch = layer.weights.shape[2]
        w_zp = broadcast_per_channel(layer.w_q.zero_point, ch, np.int32)
        c1 = broadcast_per_channel(layer.c1, ch, np.float32)
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
        if kernels:
            from ..kernels.qsoftmax import qsoftmax

            return qsoftmax(x, in_scale=layer.in_q.scale0, out_scale=layer.out_q.scale0,
                            out_zp=layer.out_q.zp0)
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
    if isinstance(layer, AddLayer):
        raise TypeError("an ADD reads two tensors: run it with apply_add")
    raise TypeError(f"unknown layer {type(layer)}")


def apply_add(layer: AddLayer, x1: torch.Tensor, x2: torch.Tensor,
              backend: str = "xla") -> torch.Tensor:
    """Run one ``ADD``: the ``qadd`` kernel on ``backend="pallas"``, the plain
    op (``ops/add.py``) otherwise; the same bits."""
    if backend == "pallas":
        from ..kernels.qadd import qadd

        return qadd(x1, x2, layer)
    from ..ops.add import add

    return add(x1, x2, layer)


def keepable(y: torch.Tensor) -> torch.Tensor:
    """``y``, or, where it is a CUDA tensor of more than ``SMALL_POOL_MAX / 2``
    and at most ``SMALL_POOL_MAX`` bytes, a copy of it at the head of a block
    of ``SMALL_POOL_MAX + 512`` bytes."""
    n = y.numel() * y.element_size()
    if not y.is_cuda or not SMALL_POOL_MAX // 2 < n <= SMALL_POOL_MAX:
        return y
    block = torch.empty(SMALL_POOL_MAX + 512, dtype=torch.uint8, device=y.device)
    return block[:n].view(y.dtype).view(y.shape).copy_(y)


def _non_int8(graph: Graph) -> list[str]:
    """The tensor types of ``graph`` other than int8, sorted."""
    dtypes = {np.dtype(graph.input_dtype)}
    for layer in graph.layers:
        for arr in (getattr(layer, "weights", None), getattr(layer, "filters", None)):
            if arr is not None:
                dtypes.add(arr.dtype)
        if isinstance(layer, QuantizeLayer):
            dtypes.add(np.dtype(layer.out_dtype))
    return sorted(str(d) for d in dtypes if d != np.int8)


def _check_int8(graph: Graph, backend: str) -> None:
    """The kernels take int8 only: refuse any other activation or weight
    type on a kernel backend."""
    bad = _non_int8(graph)
    if bad:
        raise ValueError(
            f"backend {backend!r} runs int8 graphs only; {graph.name!r} has {bad} "
            "tensors (use backend='xla')")


def select_backend(graph: Graph, backend: str | None, device_type: str):
    """The backend a model of ``graph`` runs on a device of type
    ``device_type`` (``"cuda"`` or ``"cpu"``) when ``backend`` is asked
    for (None: ``default_backend()``), and its plan: the flat plan for
    ``"flat"``, the packed plan for ``"packed"``, the hybrid split index for
    ``"hybrid"``: ``(backend, plan)``.  Raises for a backend that is unknown
    or that cannot run the graph.  Host work only."""
    if backend is None:
        backend = default_backend()
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose one of {sorted(BACKENDS)}")
    from ..kernels.flatpack import plan_flat
    from ..kernels.megakernel import fusable, hybrid_split_index
    from ..kernels.packed import plan_packed

    plan = None
    if backend == "auto":
        if device_type != "cuda":
            return "xla", None
        if any(isinstance(layer, (Conv2DLayer, DepthwiseConv2DLayer)) for layer in graph.layers):
            plan = plan_flat(graph)
        backend = "pallas" if plan is None else "flat"
    elif backend == "flat":
        plan = plan_flat(graph)
        if plan is None:
            raise ValueError("graph is not flat-packable; use backend='xla'")
    elif backend == "packed":
        plan = plan_packed(graph)
        if plan is None:
            raise ValueError("graph is not packable; use backend='xla'")
    elif backend in ("fused", "hybrid"):
        if not fusable(graph):
            raise ValueError("graph is not megakernel-fusable; use backend='xla'")
        plan = hybrid_split_index(graph) if backend == "hybrid" else 0
    if backend != "xla":
        _check_int8(graph, backend)
    return backend, plan


def resolve_backend(graph: Graph, device_type: str) -> str:
    """What ``backend="auto"`` means for ``graph`` on a device of type
    ``device_type``; raises where it cannot run the graph."""
    return select_backend(graph, "auto", device_type)[0]


class CompiledModel:
    """The built model: batched, eager, params as a dict of tensors on
    ``device``."""

    def __init__(self, graph: Graph, backend: str | None = None, device=None):
        self.graph = graph
        self.device = resolve_device(device)
        self.backend, plan = select_backend(graph, backend, self.device.type)
        self._flat = self._colfc = self._packed = self._fused_forward = None
        # the weights the kernels are built from (the setter refuses a baked backend)
        self._params, self._folds = init_params(graph, self.device), {}
        per_op_layers = graph.layers if self.backend == "pallas" else []
        if self.backend == "flat":
            from ..kernels.flatpack import kernel_from_plan

            self._flat = kernel_from_plan(plan, os.environ.get("MFT_FLAT_REQUANT", "exact2"),
                                          device=self.device)
            per_op_layers = graph.layers[self._flat[1]:]
        elif self.backend == "packed":
            from ..kernels.packed import PackedKernel

            ops, n_layers, meta = plan
            self._packed = PackedKernel(graph, ops, self.device), n_layers, meta
            per_op_layers = graph.layers[n_layers:]
        elif self.backend in ("fused", "hybrid"):
            from ..kernels.megakernel import FusedForward

            self._fused_forward = FusedForward(graph, plan, self.params, self.device)
        elif self.backend == "colfc":
            from ..kernels.colfc import build_col_kernel

            self._colfc = build_col_kernel(graph, device=self.device)
            if self._colfc is None:
                raise ValueError(
                    "graph is not a colfc-packable tiny-FC chain; use backend='xla'")
        # the flat and packed prefixes' tails run the per-op kernels on CUDA
        # and the plain ops on the CPU
        self._tail_backend = "pallas" if self.device.type == "cuda" else "xla"
        self._consts = {layer.index: layer_constants(layer, self.device)
                        for layer in per_op_layers}
        # a graph with wiring: the tensors no later layer reads, after each layer
        self._frees = graph.wiring.frees() if graph.wiring is not None else None

    @property
    def baked(self) -> bool:
        """Whether the backend baked the weights into its kernel's plan at
        build, so that ``params`` cannot be swapped."""
        return self.backend in BAKED_BACKENDS

    @property
    def params(self) -> dict:
        return self._params

    @params.setter
    def params(self, params: dict) -> None:
        if self.baked:
            raise ValueError(
                f"backend {self.backend!r} bakes the weights into its kernel's plan at "
                "build; swap params on backend 'xla' or 'pallas', or build from a graph "
                "that holds the new weights")
        self._params = params
        self._folds = {}  # the walk's conv_folds and dw_folds, by layer index

    def _forward(self, xq: torch.Tensor) -> torch.Tensor:
        if self._flat is not None:
            return self._flat_forward(xq)
        if self._packed is not None:
            return self._packed_forward(xq)
        if self._fused_forward is not None:
            return self._fused_forward(xq)
        if self._colfc is not None:
            col_fn, meta = self._colfc
            y = col_fn(xq.reshape(xq.shape[0], meta["k0"]))
            return y.reshape(xq.shape[0], *self.graph.output_shape)
        if self._frees is not None:
            return self._walk(xq, 0, self.backend)
        for layer in self.graph.layers:
            xq = apply_layer(layer, self.params, xq, self.backend, self._consts.get(layer.index))
        return xq

    def _walk(self, x: torch.Tensor, start: int, backend: str) -> torch.Tensor:
        """The layers from ``start`` on of a graph with wiring, ``x`` being
        the tensor layer ``start`` reads: each layer takes its inputs by
        tensor id, and a tensor is dropped after its last reader.  The most
        activation bytes held at once (from shapes, on the host) go to the
        counter ``mft.graph.live_peak_bytes``; each ``ADD`` is a span
        ``mft.op.add``."""
        w, layers = self.graph.wiring, self.graph.layers
        held = {w.layers[start - 1][1] if start else w.input: x}
        size = peak = x.numel() * x.element_size()
        for i in range(start, len(layers)):
            layer, (ins, out) = layers[i], w.layers[i]
            if isinstance(layer, AddLayer):
                with trace.Span(trace.ADD_SPAN):
                    y = apply_add(layer, held[ins[0]], held[ins[1]], backend)
            else:
                y = apply_layer(layer, self.params, held[ins[0]], backend,
                                self._consts.get(layer.index),
                                self._layer_folds(layer) if backend == "pallas" else None)
            held[out] = y
            size += y.numel() * y.element_size()
            peak = max(peak, size)
            for t in self._frees[i]:
                gone = held.pop(t)
                size -= gone.numel() * gone.element_size()
        trace.level(trace.LIVE_PEAK, peak)
        return held[w.output]

    def _flat_forward(self, xq: torch.Tensor) -> torch.Tensor:
        """The flat kernel on the prefix, then the tail layers."""
        flat_fn, n_layers, meta = self._flat
        b = xq.shape[0]
        x = flat_fn(xq.reshape(b, meta["in_lanes"])).reshape(b, *meta["out_shape"])
        return self._tail(x, n_layers)

    def _packed_forward(self, xq: torch.Tensor) -> torch.Tensor:
        """The packed kernel on the prefix, then the tail layers."""
        packed_fn, n_layers, _ = self._packed
        return self._tail(packed_fn(xq.contiguous()), n_layers)

    def _layer_folds(self, layer) -> dict | None:
        """A conv's or depthwise layer's ``conv_folds``/``dw_folds`` for the
        walk, made at its first call after ``params`` is assigned and kept
        until the next assignment.  The walk takes its params as read-only:
        a graph with wiring is never trained, and a caller that writes the
        tensors in place assigns ``params`` again (``m.params = m.params``)
        for the walk to see the write.  The chain graphs' per-op layers,
        which a trainer updates every step, make theirs at every call."""
        if not isinstance(layer, (Conv2DLayer, DepthwiseConv2DLayer)):
            return None
        folds = self._folds.get(layer.index)
        if folds is None:
            fold = conv_folds if isinstance(layer, Conv2DLayer) else dw_folds
            folds = self._folds[layer.index] = fold(layer, self.params[f"layer{layer.index}"],
                                                    self._consts[layer.index])
        return folds

    def _tail(self, x: torch.Tensor, n_layers: int) -> torch.Tensor:
        if self._frees is not None:
            return self._walk(x, n_layers, self._tail_backend)
        for layer in self.graph.layers[n_layers:]:
            x = apply_layer(layer, self.params, x, self._tail_backend,
                            self._consts.get(layer.index))
        return x

    def _input(self, x, dtype) -> torch.Tensor:
        return as_device(x, self.device).to(dtype)

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
        """int [B, *input_shape] -> int [B, *output_shape] (``keepable``)."""
        with trace.Span("mft.predict", root=True):
            return keepable(self._forward(self._input(xq, torch_dtype(self.graph.input_dtype))))

    def export(self, path: str | None = None) -> bytes:
        """The model with its current params (a ``TrainableModel``'s trained
        ones after ``update_layers``) as ``.tflite`` bytes
        (``frontend/export.py``), written to ``path`` when given.  An
        untrained model round-trips bit-exactly; a trained folded bias is
        quantized to the nearest integer bias."""
        from ..frontend.export import export_tflite

        data = export_tflite(self.graph, self.params,
                             description=f"microflow_tpu_torch export: {self.graph.name}")
        if path:
            with open(path, "wb") as f:
                f.write(data)
        return data

    def expansion(self, batch_size: int = 1) -> str:
        """What a forward of ``batch_size`` samples runs, without running it
        (``compiler/expansion.py``): the layer table, the backend, and each
        layer's or kernel op's shapes and the function that computes it on
        the model's device."""
        from .expansion import expansion

        return expansion(self, batch_size)


def build(graph: Graph, backend: str | None = None, device=None) -> CompiledModel:
    return CompiledModel(graph, backend=backend, device=device)


def compile_tflite(path: str, name: str | None = None, backend: str | None = None,
                   device=None) -> CompiledModel:
    """One-call front door: ``.tflite`` path -> compiled batched model on
    ``device`` (default CUDA; raises if CUDA is absent)."""
    from ..frontend.parser import parse

    device = resolve_device(device)
    return build(parse(path, name=name), backend=backend, device=device)
