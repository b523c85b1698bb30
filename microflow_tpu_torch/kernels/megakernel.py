"""The megakernel (CUDA, ``csrc/megakernel.cu``): backends ``"fused"`` and
``"hybrid"``.

Port of ``microflow_tpu/kernels/megakernel.py``: ``build_fused_forward``
splits a graph into *segments* of consecutive layers and runs each segment
in one launch (``_segment_call``), every intermediate tensor kept on chip.
The segmentation is the JAX package's:

* a ``ReshapeLayer``, and a FullyConnected that flattens or sees an input
  of rank other than 1, ends the segment; the reshape between segments is
  a free view;
* a segment that opens with a depthwise conv whose channel count differs
  from its input's carries the JAX package's channel gather
  (``Segment.gather``: channel ``c`` reads input channel ``c < in_c ? c :
  0``).  On the card the kernel's depthwise op reads the input in place
  with that rule, so no gathered copy of the input is made;
* a trailing Softmax runs outside the kernel, as the plain ``ops.softmax``;
* ``start_index > 0`` is ``"hybrid"``: the layers before it run one op at
  a time, through the per-op kernels (``qgemm``, ``qdwconv``) on CUDA and
  the plain ops on the CPU, as the JAX package runs them through XLA.

Ops inside a segment: depthwise conv (any window and stride, per-channel
``w_zp``), Conv2D (any window and stride, per-channel ``w_zp``),
FullyConnected (``w_zp``, ``c2``, ``c3``), AveragePool (true-zero padding,
the reciprocal plane) and int8 Quantize.  Every requant rounds half away
from zero, as the JAX kernel's ``lax.round(..., AWAY_FROM_ZERO)``:
``y = bias0 + c1 * f32(q)`` (multiply, then add), ``clip(roundf(y), lo,
hi)``.  Both TPU kernels compute exactly the chain of the plain ops, so
the plain version ``segment_reference`` is that chain.

The plan is written in the flat kernel's descriptor layout, and the
kernel shares the flat kernel's paths for its largest classes
(``csrc/segment_ops.cuh``), chosen per op by the flat plan's rules on
shape (``kernels/flatpack.py::dw3_path``, ``dw_vec``, ``pw_mma``):

* a depthwise conv whose centred taps ``w - w_zp[c]`` all fit int8 takes
  the 3x3 strips (``op_dw3``, ``op_dw3_stem``: ``F_DW3``) or four channels
  a thread (``op_dw_vec``: ``F_VEC``) where its shape allows, with
  ``d[c] = -in_zp * the sum of c's centred taps``; any other depthwise conv
  takes ``op_dw`` with int32 taps;
* a 1x1 conv with every ``w_zp[f] == 0`` takes the tensor cores
  (``op_pw_mma``: ``F_MMA``) where its shape allows, with ``d[f] = -in_zp *
  colsum``; any other over a multiple of 4 channels takes ``op_pw``
  (``__dp4a``, ``w_zp[f]`` times the pixel's channel sum); the rest
  ``op_conv``.

``SegmentKernel.paths`` names the path of each op (``op_path``).

Not carried over: the TPU's VMEM budget, batch tile and padding, lane
padding, and stride-by-sweep-then-decimate; nor any ``MFT_*`` variable.
One rule is the port's own: a block holds one sample's input and output
tensors of each op in shared memory (two ping-pong buffers), so a segment
whose pair would not fit ``SMEM_BYTES`` raises at build.  No bundled or
synthetic graph reaches it.  Unlike the JAX package, which re-plans from
``params`` on every call, the plan bakes the weights at build.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..compiler.ir import (
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    Graph,
    QuantizeLayer,
    ReshapeLayer,
    SoftmaxLayer,
    chain_length,
)
from ..core.activation import activation_bounds
from ..core.numerics import broadcast_per_channel
from . import LAUNCHES, build
from .flatpack import (
    DW3_NONE,
    DW3_S1,
    DW3_S2,
    DW3_STEM,
    F_BIAS,
    F_C1,
    F_D,
    F_DW3,
    F_EXACT,
    F_HI,
    F_IC,
    F_IH,
    F_IN,
    F_IW,
    F_KH,
    F_KIND,
    F_KW,
    F_LO,
    F_MMA,
    F_OC,
    F_OH,
    F_OUT,
    F_OUTZP,
    F_OW,
    F_PL,
    F_PT,
    F_RECIP,
    F_S0,
    F_S1,
    F_SC,
    F_SR,
    F_VEC,
    F_W,
    F_WZP,
    F_ZP,
    NF,
    SMEM_BYTES,
    PlanBuffer,
    _f32_bits,
    _smem_split,
    dw3_path,
    dw3_words,
    dw_offsets,
    dw_vec,
    dw_vec_words,
    mma_fragments,
    pw_mma,
)

# Op kinds; csrc/megakernel.cu reads the same numbers.  The descriptor is
# the flat kernel's (kernels/flatpack.py, NF fields), F_WZP included.
KINDS = {"dw": 0, "conv": 1, "pw": 2, "fc": 3, "pool": 4, "quantize": 5}
DW3_PATHS = {DW3_S1: "dw3_s1", DW3_S2: "dw3_s2", DW3_STEM: "dw3_stem"}


def fusable(graph: Graph) -> bool:
    """True when every layer is one the megakernel runs and the model is
    int8: Conv2D, DepthwiseConv2D, FullyConnected, AveragePool2D, Reshape,
    int8 Quantize, and a Softmax only as the last layer, in one chain
    (``chain_length``)."""
    if np.dtype(graph.input_dtype) != np.int8 or chain_length(graph) != len(graph.layers):
        return False
    for i, layer in enumerate(graph.layers):
        if isinstance(layer, SoftmaxLayer):
            if i != len(graph.layers) - 1:
                return False
        elif isinstance(layer, QuantizeLayer):
            if np.dtype(layer.out_dtype) != np.int8:
                return False
        elif not isinstance(layer, (Conv2DLayer, DepthwiseConv2DLayer, FullyConnectedLayer,
                                    AveragePool2DLayer, ReshapeLayer)):
            return False
    return True


def hybrid_split_index(graph: Graph, min_channels: int = 64) -> int:
    """The first layer whose per-sample input has a last dimension of at
    least ``min_channels`` (the JAX package's lane-efficiency rule), or
    ``len(graph.layers)`` when there is none, and never past the graph's
    plain chain (``chain_length``).  A softmax is never the split."""
    shape = tuple(graph.input_shape)
    for i, layer in enumerate(graph.layers[:chain_length(graph)]):
        if len(shape) >= 1 and shape[-1] >= min_channels and not isinstance(layer, SoftmaxLayer):
            return i
        shape = tuple(getattr(layer, "out_shape", shape))
    return chain_length(graph)


@dataclass
class Segment:
    """Consecutive layers run in one launch: int8 [B, *in_shape] ->
    int8 [B, *out_shape]."""

    layers: list
    in_shape: tuple
    out_shape: tuple
    gather: list | None = None  # the JAX package's channel gather at entry
    shapes: list = field(default_factory=list)  # (in_shape, out_shape) per layer

    @property
    def indices(self) -> list[int]:
        return [layer.index for layer in self.layers]

    @property
    def in_elems(self) -> int:
        return int(np.prod(self.in_shape))

    @property
    def out_elems(self) -> int:
        return int(np.prod(self.out_shape))

    def macs(self) -> int:
        """Multiply-adds per sample, every window tap counted."""
        return sum(layer_macs(layer, out) for layer, (_, out) in zip(self.layers, self.shapes))


def layer_macs(layer, out_shape) -> int:
    """Multiply-adds per sample of one layer, every window tap counted."""
    if isinstance(layer, DepthwiseConv2DLayer):
        return int(np.prod(out_shape)) * layer.geom.k_rows * layer.geom.k_cols
    if isinstance(layer, Conv2DLayer):
        return int(np.prod(out_shape)) * int(np.prod(layer.filters.shape[1:]))
    if isinstance(layer, FullyConnectedLayer):
        return int(layer.weights.size)
    return 0


def op_kind(layer, in_shape) -> str:
    """The kernel's op for a layer of a segment (a key of ``KINDS``)."""
    if isinstance(layer, QuantizeLayer):
        return "quantize"
    if isinstance(layer, AveragePool2DLayer):
        return "pool"
    if isinstance(layer, FullyConnectedLayer):
        return "fc"
    if isinstance(layer, DepthwiseConv2DLayer):
        return "dw"
    one = layer.geom.k_rows == layer.geom.k_cols == 1
    return "pw" if one and in_shape[2] % 4 == 0 else "conv"


def plan_segments(graph: Graph, start_index: int = 0):
    """The JAX package's segmentation of the layers from ``start_index``:
    ``(steps, tail_softmax)`` with steps ``("reshape", shape)`` or
    ``("segment", Segment)``.  Raises ``TypeError`` for a layer the
    megakernel does not run, ``ValueError`` for a graph that is not one
    chain (``chain_length``)."""
    if chain_length(graph) != len(graph.layers):
        raise ValueError("megakernel: the graph is not one chain of layers")
    layers = list(graph.layers)
    tail = None
    if layers and isinstance(layers[-1], SoftmaxLayer):
        tail = layers.pop()
    prefix = [layer for layer in layers if layer.index < start_index]
    layers = [layer for layer in layers if layer.index >= start_index]
    shape = tuple(prefix[-1].out_shape) if prefix else tuple(graph.input_shape)
    steps, cur, cur_in = [], [], shape
    shapes = []

    def flush():
        nonlocal cur, shapes
        if cur:
            gather = None
            first = cur[0]
            if isinstance(first, DepthwiseConv2DLayer) and first.weights.shape[2] != cur_in[-1]:
                ch, in_c = first.weights.shape[2], cur_in[-1]
                gather = [c if c < in_c else 0 for c in range(ch)]
            steps.append(("segment", Segment(cur, cur_in, shape, gather, shapes)))
            cur, shapes = [], []

    for layer in layers:
        if isinstance(layer, ReshapeLayer):
            flush()
            shape = cur_in = tuple(layer.out_shape)
            steps.append(("reshape", shape))
            continue
        if isinstance(layer, FullyConnectedLayer) and (layer.flatten_input or len(shape) != 1):
            flush()
            shape = cur_in = (int(np.prod(shape)),)
            steps.append(("reshape", shape))
        elif not isinstance(layer, (FullyConnectedLayer, DepthwiseConv2DLayer, Conv2DLayer,
                                    AveragePool2DLayer, QuantizeLayer)):
            raise TypeError(f"megakernel: unsupported layer {type(layer).__name__}")
        cur.append(layer)
        shapes.append((shape, tuple(layer.out_shape)))
        shape = tuple(layer.out_shape)
    flush()
    return steps, tail


# --- the plain version --------------------------------------------------------


def segment_reference(segment: Segment, params: dict, x: torch.Tensor) -> torch.Tensor:
    """The plain torch version of the kernel: the segment's layers through
    the plain ops (``apply_layer(..., "xla")``) on ``params``.  The plain
    depthwise op applies the channel gather itself."""
    from ..compiler.builder import apply_layer

    for layer in segment.layers:
        x = apply_layer(layer, params, x, "xla")
    return x


# --- the device plan ----------------------------------------------------------


def _i32(values, what: str) -> np.ndarray:
    values = np.asarray(values, np.int64)
    if np.any(values != values.astype(np.int32)):
        raise ValueError(f"megakernel: {what} does not fit in int32")
    return values.astype(np.int32)


def _shape3(shape) -> tuple:
    return tuple(shape) if len(shape) == 3 else (1, 1, int(np.prod(shape)))


def pack_segment(segment: Segment) -> tuple[np.ndarray, int, int]:
    """The segment's plan as one byte buffer for the kernel, and its two
    shared-memory buffer sizes.  Raises when one sample's pair of tensors
    would not fit in ``SMEM_BYTES`` (the port's rule)."""
    sizes = [int(np.prod(out)) for _, out in segment.shapes]
    smem_a, smem_b = _smem_split(sizes, segment.in_elems)
    if smem_a + smem_b > SMEM_BYTES:
        raise ValueError(
            f"megakernel: segment {segment.indices} needs {smem_a + smem_b} bytes of shared "
            f"memory per sample, more than the {SMEM_BYTES} one block may use")
    plan = PlanBuffer(len(segment.layers), NF)
    for f, layer, (in_shape, out_shape) in zip(plan.desc, segment.layers, segment.shapes):
        kind = op_kind(layer, in_shape)
        f[F_KIND] = KINDS[kind]
        f[F_IH], f[F_IW], f[F_IC] = _shape3(in_shape)
        f[F_OH], f[F_OW], f[F_OC] = _shape3(out_shape)
        f[F_IN], f[F_OUT] = int(np.prod(in_shape)), int(np.prod(out_shape))
        f[F_LO], f[F_HI] = -128, 127
        f[F_EXACT] = 1  # every requant rounds half away from zero
        if kind == "quantize":
            f[F_ZP], f[F_OUTZP] = layer.in_q.zp0, layer.out_q.zp0
            f[F_S0], f[F_S1] = _f32_bits(layer.in_q.scale0), _f32_bits(layer.out_q.scale0)
            continue
        f[F_LO], f[F_HI] = activation_bounds(layer.activation, layer.out_q.scale0,
                                             layer.out_q.zp0)
        geom = getattr(layer, "geom", None)
        if geom is not None:
            top, _, left, _ = geom.pad_amounts()
            f[F_KH], f[F_KW], f[F_SR], f[F_SC], f[F_PT], f[F_PL] = (
                geom.k_rows, geom.k_cols, geom.stride_rows, geom.stride_cols, top, left)
        if kind == "pool":
            f[F_S0], f[F_S1] = _f32_bits(layer.c0), _f32_bits(layer.c1)
            f[F_RECIP] = plan.put((np.float32(1.0) / geom.len_plane().astype(np.float32))
                                  .astype(np.float32).reshape(-1))
            continue
        in_zp = layer.in_q.zp0
        f[F_ZP] = in_zp
        c_out = int(out_shape[-1])
        if kind == "fc":
            f[F_S0] = layer.w_q.zp0
            f[F_W] = plan.put(np.ascontiguousarray(layer.weights.T).astype(np.int8))  # [N, K]
            f[F_D] = plan.put(_i32(int(layer.c3) - layer.c2.astype(np.int64), "c3 - c2"))
            c1 = np.full(c_out, layer.c1, np.float32)
        else:
            wzp = broadcast_per_channel(layer.w_q.zero_point, c_out, np.int64)
            c1 = broadcast_per_channel(layer.c1, c_out, np.float32)
            if kind == "dw":
                wc = layer.weights.astype(np.int64) - wzp[None, None, :]  # [KH, KW, C]
                int8_taps = wc.min() >= -128 and wc.max() <= 127
                path = dw3_path(geom, in_shape, out_shape) if int8_taps else DW3_NONE
                if path or (int8_taps and dw_vec(in_shape, out_shape)):
                    w8 = wc.astype(np.int8)
                    f[F_DW3], f[F_VEC] = path, int(not path)
                    f[F_W] = plan.put(dw3_words(w8) if path else dw_vec_words(w8))
                    f[F_D] = plan.put(_i32(dw_offsets(w8, in_zp), "d"))
                else:
                    f[F_W] = plan.put(wc.reshape(-1, c_out).astype(np.int32))
            elif kind == "pw":
                c_in = in_shape[2]
                w = layer.filters.reshape(c_out, c_in)
                if not wzp.any() and pw_mma(in_shape, out_shape):
                    f[F_MMA] = 1
                    f[F_W] = plan.put(mma_fragments(w))
                else:
                    # [C/4][F] words: word (k, f) packs input channels
                    # 4k..4k+3 of filter f
                    words = np.ascontiguousarray(w.reshape(c_out, c_in // 4, 4).transpose(1, 0, 2))
                    f[F_W] = plan.put(words.view(np.int32).reshape(c_in // 4, c_out))
                    f[F_WZP] = plan.put(_i32(wzp, "w_zp"))
                # d = C*in_zp*w_zp - in_zp*colsum (-in_zp*colsum on the tensor cores)
                f[F_D] = plan.put(_i32(c_in * in_zp * wzp - in_zp * w.astype(np.int64).sum(1),
                                       "d"))
            else:
                f[F_W] = plan.put(layer.filters.astype(np.int8))  # [F, KH, KW, C]
                f[F_WZP] = plan.put(_i32(wzp, "w_zp"))
        f[F_BIAS] = plan.put((np.float32(layer.out_q.zp0) + layer.c0.astype(np.float32))
                             .astype(np.float32))
        f[F_C1] = plan.put(c1)
    return plan.bytes(), smem_a, smem_b


def op_path(desc, kinds: dict = KINDS) -> str:
    """The kernel's path for an op, from its descriptor: ``"dw3_s1"``,
    ``"dw3_s2"``, ``"dw3_stem"``, ``"dw_vec"`` or ``"dw"`` for a depthwise
    conv, ``"pw_mma"`` or ``"pw"`` for a 1x1 conv over a multiple of 4
    channels, else the op's kind (``"conv"``, ``"fc"``, ``"pool"``,
    ``"quantize"``; the flat kernel's ``kinds`` have ``"softmax"``)."""
    kind = {v: k for k, v in kinds.items()}[int(desc[F_KIND])]
    if kind == "dw":
        return DW3_PATHS.get(int(desc[F_DW3]), "dw_vec" if desc[F_VEC] else "dw")
    if kind == "pw" and desc[F_MMA]:
        return "pw_mma"
    return kind


class SegmentKernel:
    """One segment: int8 [B, *in_shape] -> int8 [B, *out_shape].  CUDA
    tensors launch the kernel on the plan's device buffer (built once);
    CPU tensors run ``segment_reference``.  ``paths`` names each op's path
    in the kernel (``op_path``)."""

    def __init__(self, segment: Segment, params: dict, device: torch.device):
        self.segment = segment
        self.params = params
        self.device = device
        self.plan = None
        buf, self.smem_a, self.smem_b = pack_segment(segment)
        n = len(segment.layers)
        # the host copy of the descriptors, which the entry point checks
        self.desc = buf[:n * NF * 4].view(np.int32).reshape(n, NF).copy()
        self.paths = [op_path(row) for row in self.desc]
        if device.type == "cuda":
            self.plan = torch.from_numpy(buf).to(device)

    def reference(self, x: torch.Tensor) -> torch.Tensor:
        return segment_reference(self.segment, self.params, x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        seg = self.segment
        if x.device.type == "cpu":
            return self.reference(x)
        if x.device.type != "cuda":
            raise ValueError(f"megakernel: unsupported device {x.device}")
        if self.plan is None or x.device != self.plan.device:
            raise ValueError(f"megakernel: the plan was built for {self.device}, not {x.device}")
        if (tuple(x.shape[1:]) != seg.in_shape or x.dtype != torch.int8
                or not x.is_contiguous()):
            raise ValueError(f"megakernel: x must be contiguous int8 [B, {seg.in_shape}], got "
                             f"{x.dtype} {tuple(x.shape)}")
        b = x.shape[0]
        out = torch.empty((b, *seg.out_shape), dtype=torch.int8, device=x.device)
        if b == 0:
            return out
        fn = build.library("megakernel").mf_megakernel
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), out.data_ptr(), b, self.plan.data_ptr(), self.desc.ctypes.data,
                    len(seg.layers), seg.in_elems, seg.out_elems, self.smem_a, self.smem_b,
                    torch.cuda.current_stream().cuda_stream)
        build.check(rc, "megakernel")
        LAUNCHES["megakernel"] += 1
        return out


class FusedForward:
    """``forward(xq) -> yq`` of backend ``"fused"`` (``start_index == 0``)
    or ``"hybrid"``: the per-op prefix, then the segments stitched with
    reshapes, then the trailing softmax as the plain op."""

    def __init__(self, graph: Graph, start_index: int, params: dict, device: torch.device):
        from ..compiler.builder import layer_constants

        self.graph = graph
        self.device = device
        self.params = params
        self.prefix = [layer for layer in graph.layers if layer.index < start_index
                       and not isinstance(layer, SoftmaxLayer)]
        self.prefix_backend = "pallas" if device.type == "cuda" else "xla"
        self.consts = {layer.index: layer_constants(layer, device) for layer in self.prefix}
        steps, self.tail = plan_segments(graph, start_index)
        self.steps = [(kind, SegmentKernel(val, self.params, device) if kind == "segment" else val)
                      for kind, val in steps]

    @property
    def segments(self) -> list[SegmentKernel]:
        return [val for kind, val in self.steps if kind == "segment"]

    def __call__(self, xq: torch.Tensor) -> torch.Tensor:
        from ..compiler.builder import apply_layer

        x = xq
        for layer in self.prefix:
            x = apply_layer(layer, self.params, x, self.prefix_backend,
                            self.consts.get(layer.index))
        for kind, val in self.steps:
            x = x.reshape(x.shape[0], *val) if kind == "reshape" else val(x.contiguous())
        if self.tail is not None:
            x = apply_layer(self.tail, self.params, x, "xla")
        return x


def build_fused_forward(graph: Graph, start_index: int = 0, device=None) -> FusedForward:
    """The forward of backend ``"fused"`` (``start_index=0``) or, with
    ``start_index = hybrid_split_index(graph)``, ``"hybrid"``, for
    ``device`` (None means CUDA, which must be present).  The weights are
    baked into the segments' plans at build.  Raises ``ValueError`` for a
    graph that is not ``fusable``."""
    from ..compiler.builder import init_params, resolve_device

    if not fusable(graph):
        raise ValueError("graph is not megakernel-fusable; use backend='xla'")
    device = resolve_device(device)
    return FusedForward(graph, start_index, init_params(graph, device), device)
