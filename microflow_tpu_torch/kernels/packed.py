"""The packed-pipeline kernel (CUDA, ``csrc/packed.cu``): backend ``"packed"``.

Port of ``microflow_tpu/kernels/packed.py::build_packed_kernel``: the
MobileNet-style depthwise/pointwise prefix of a graph in one launch.  Ops:
the stem (a 3x3 depth-multiplier depthwise conv over the single-channel
input, any stride), 3x3 depthwise convs and 1x1 convs.

``plan_packed`` keeps every packing rule of the JAX package, so that
``n_layers`` and ``meta`` are its: a 3x3 stem on a single-channel int8
input; lanes ``W*C`` a multiple of 128 and at most ``MAX_LANES``;
``C`` dividing 128; every ``w_zp == 0``; 1x1 stride-1 pointwise layers
with ``C_out <= 128`` whose TPU dot windows tile; the prefix ends on a
layer that leaves nothing to decimate, and packs at least 4 layers.  Three
rules are the port's own, and cut only where the JAX kernel would compute
another function than the reference (its planner does not look at them):
the stem and the depthwise layers use SAME padding, the pointwise layers
have column stride 1, and a stride-2 depthwise layer is followed by an
even width.

The plain version, ``packed_reference`` on the ``PackedOp``s, is the JAX
kernel's algebra: each activation held as ``H + 2`` rows of ``W*C`` lanes,
the two *guard rows* holding the zero point, and per-lane planes ``d`` =
``-in_zp * wsum`` plus the constant that the horizontal out-of-bounds taps
would add (``edge_d``), ``bias0`` and ``c1``; a tap outside the row is
skipped and its constant comes from ``d``.  Where the JAX kernel sweeps a
stride-2 depthwise layer at every column and folds the column decimation
into the next pointwise matrix, the plain version computes the true
strided output, reading the planes at the swept columns it keeps.  Every
requant rounds half away from zero: ``clip(roundf(bias0 + c1 * f32(q)),
lo, hi)``, the multiply and the add rounded apart.

The card runs another plan of the same function (``device_ops``): the
flat kernel's ops of the same layers in the flat descriptor layout
(``pack_plan(ops, "exact")``), which the shared strip, tensor-core and
general paths read with no guard rows and no planes.  Both forms compute
``sum over in-bounds taps (x - in_zp) * w`` per output (the top and left
SAME padding of a 3x3 window is 1, as the guard rows and ``edge_d``
assume), then the same epilogue, so the kernel's bits are the plain
version's; the CPU tests hold the two forms equal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..compiler.ir import Conv2DLayer, DepthwiseConv2DLayer, Graph, chain_length
from ..core.activation import activation_bounds
from ..core.numerics import broadcast_per_channel, f32, round_away
from ..core.tensor import ViewPadding
from . import LAUNCHES, build
from .flatpack import NF, SMEM_BYTES, FlatOp, mac_op, pack_plan
from .megakernel import op_path

LANE = 128
MAX_LANES = 2048


@dataclass
class PackedOp:
    """One layer of the packed prefix: the JAX plan's fields (rows, lanes,
    stride, zero points, planes, clip bounds) and the geometry the card
    computes (``w_in``/``w_out``: the true column counts)."""

    kind: str  # "stem" | "dw" | "pw"
    layer_idx: int
    h_in: int  # data rows in (guards excluded)
    h_out: int
    lanes_in: int  # the JAX layout's lanes (a stride-2 dw keeps every column)
    lanes_out: int
    stride: int
    pad_value: int  # input zero point (the input's guard rows)
    out_zp: int  # output zero point (the output's guard rows)
    weights: np.ndarray  # stem/dw [3, 3, C] int8; pw [C_out, C_in] int8
    w_in: int
    c_in: int
    w_out: int
    c_out: int
    stride_cols: int = 1
    plane_step: int = 1  # the plane lane of output column j is plane_step*j*c_out + c
    d_plane: np.ndarray | None = None  # i32 [1, lanes_out]
    bias_plane: np.ndarray | None = None  # f32 [1, lanes_out]
    c1_plane: np.ndarray | None = None  # f32 [1, lanes_out]
    clip_lo: float = -128.0
    clip_hi: float = 127.0

    def macs(self) -> int:
        """Multiply-adds per sample of the true strided output."""
        taps = self.c_in if self.kind == "pw" else 9
        return self.h_out * self.w_out * self.c_out * taps


def _requant_planes(op: PackedOp, layer, base_d: np.ndarray, w: int, c_out: int) -> None:
    """The JAX package's per-lane ``d``, ``bias0``, ``c1`` planes over
    ``w * c_out`` lanes and the activation's clip bounds."""
    n = w * c_out
    cidx = np.arange(n) % c_out
    op.d_plane = base_d.astype(np.int64).reshape(1, n).astype(np.int32)
    bias0 = np.float32(layer.out_q.zp0) + layer.c0.astype(np.float32)
    op.bias_plane = bias0[cidx].astype(np.float32).reshape(1, n)
    op.c1_plane = broadcast_per_channel(layer.c1, c_out, np.float32)[cidx].reshape(1, n)
    lo, hi = activation_bounds(layer.activation, layer.out_q.scale0, layer.out_q.zp0)
    op.clip_lo, op.clip_hi = float(lo), float(hi)
    op.out_zp = layer.out_q.zp0


def _edge_d(k: np.ndarray, c: int, w_in: int, w_sweep: int, stride: int, in_zp: int) -> np.ndarray:
    """int64 [w_sweep * c]: per lane (column wp, channel ch) the sum of
    ``k[dh, dw, ch] * in_zp`` over the taps whose column ``stride*wp + dw -
    1`` lies outside the input (the JAX package's ``edge_d`` and
    ``_stem_edge_d``)."""
    lanes = np.arange(w_sweep * c)
    wp, ch = lanes // c, lanes % c
    edge = np.zeros(w_sweep * c, np.int64)
    for dw in range(k.shape[1]):
        wi = stride * wp + dw - (k.shape[1] - 1) // 2
        oob = (wi < 0) | (wi >= w_in)
        edge += oob * k[:, dw, :].astype(np.int64).sum(axis=0)[ch] * in_zp
    return edge


def plan_packed(graph: Graph, max_layers: int | None = None):
    """Plan the maximal packable dw/pw prefix: ``(ops, n_layers, meta)``, or
    None if it does not pack.  ``meta``: ``h_out``, ``lanes_out``,
    ``w_out``, ``c_out``, ``in_rows``, ``in_cols``.  It takes no layer past
    the graph's plain chain (``chain_length``)."""
    layers = graph.layers[:chain_length(graph)]
    if not layers or not isinstance(layers[0], DepthwiseConv2DLayer):
        return None
    g0 = layers[0].geom
    if g0.k_rows != 3 or g0.k_cols != 3 or np.dtype(graph.input_dtype) != np.int8:
        return None

    ops = []
    h, w, c = g0.in_rows, g0.in_cols, 1
    w_true = w  # columns the card holds (the JAX layout keeps a stride-2 dw's sweep)
    decim = 1
    n = n_safe = 0
    for i, layer in enumerate(layers):
        if max_layers is not None and i >= max_layers:
            break
        if isinstance(layer, DepthwiseConv2DLayer):
            geom = layer.geom
            k = layer.weights
            c_out = k.shape[2]
            if np.any(broadcast_per_channel(layer.w_q.zero_point, c_out, np.int64) != 0):
                break
            in_zp = layer.in_q.zp0
            wsum = k.astype(np.int64).sum(axis=(0, 1))
            if i == 0:
                w_out = geom.out_cols
                if (len(graph.input_shape) != 3 or graph.input_shape[-1] != 1
                        or (w_out * c_out) % LANE or w_out * c_out > MAX_LANES
                        or LANE % c_out or geom.padding is not ViewPadding.SAME):
                    return None
                op = PackedOp("stem", i, h, geom.out_rows, w, w_out * c_out, geom.stride_rows,
                              in_zp, 0, np.array(k), w, 1, w_out, c_out, geom.stride_cols)
                cidx = np.arange(w_out * c_out) % c_out
                base_d = (-np.int64(in_zp) * wsum[cidx]
                          + _edge_d(k, c_out, w, w_out, geom.stride_cols, in_zp))
                _requant_planes(op, layer, base_d, w_out, c_out)
                h, w, c = geom.out_rows, w_out, c_out
                w_true = w_out
                decim = 1
            else:
                if (geom.k_rows != 3 or geom.k_cols != 3 or c_out != c
                        or decim != 1 or (w * c) % LANE or w * c > MAX_LANES
                        or c > LANE or LANE % c or (w * c) // LANE < 2
                        or geom.padding is not ViewPadding.SAME):
                    break
                op = PackedOp("dw", i, h, geom.out_rows, w * c, w * c, geom.stride_rows,
                              in_zp, 0, np.array(k), w_true, c, geom.out_cols, c,
                              geom.stride_cols, plane_step=geom.stride_cols)
                cidx = np.arange(w * c) % c_out
                base_d = -np.int64(in_zp) * wsum[cidx] + _edge_d(k, c, w, w, 1, in_zp)
                _requant_planes(op, layer, base_d, w, c_out)
                h = geom.out_rows
                w_true = geom.out_cols
                decim = geom.stride_cols
        elif isinstance(layer, Conv2DLayer):
            geom = layer.geom
            f = layer.filters
            if (geom.k_rows != 1 or geom.k_cols != 1 or geom.stride_rows != 1
                    or geom.stride_cols != 1):
                break
            c_out, c_in = f.shape[0], f.shape[3]
            if c_in != c or c_out > LANE or LANE % c_out:
                break
            if np.any(broadcast_per_channel(layer.w_q.zero_point, c_out, np.int64) != 0):
                break
            w_out = w // decim
            lanes_out = w_out * c_out
            if lanes_out % LANE or lanes_out > MAX_LANES or (w * c) % LANE or w_out != w_true:
                break
            # the JAX kernel's dot windows: they must tile its lanes
            t = c_out // math.gcd(c_out, decim * c_in)
            out_cols = min(t * LANE, lanes_out)
            if lanes_out % out_cols:
                break
            if (out_cols // c_out) * decim * c_in % LANE:
                break
            op = PackedOp("pw", i, h, h, w * c, lanes_out, 1, layer.in_q.zp0, 0,
                          np.array(f.reshape(c_out, c_in)), w_true, c_in, w_out, c_out)
            wsum = f.astype(np.int64).sum(axis=(1, 2, 3))
            cidx = np.arange(lanes_out) % c_out
            _requant_planes(op, layer, -np.int64(layer.in_q.zp0) * wsum[cidx], w_out, c_out)
            w, c = w_out, c_out
            w_true = w_out
            decim = 1
        else:
            break
        ops.append(op)
        n = i + 1
        if decim == 1:
            n_safe = n

    ops = ops[: len(ops) - (n - n_safe)]
    n = n_safe
    if n < 4:
        return None
    last = ops[-1]
    meta = dict(h_out=last.h_out, lanes_out=last.lanes_out, w_out=last.lanes_out // c,
                c_out=c, in_rows=g0.in_rows, in_cols=g0.in_cols)
    return ops, n, meta


# --- the plain version --------------------------------------------------------


def _plane(op: PackedOp, plane: np.ndarray, device) -> torch.Tensor:
    """[w_out, c_out] of a plane at the columns the op computes."""
    p = plane.reshape(-1, op.c_out)[:: op.plane_step][: op.w_out]
    return torch.from_numpy(np.ascontiguousarray(p)).to(device)


def _op_reference(op: PackedOp, x: torch.Tensor) -> torch.Tensor:
    """One op on int8 [B, h_in, w_in, c_in] -> [B, h_out, w_out, c_out], as
    the kernel computes it: guard rows of ``pad_value`` above and below,
    out-of-row taps skipped, the plane ``d`` added."""
    dev = x.device
    if op.kind == "pw":
        w = torch.from_numpy(op.weights).to(dev, torch.float64)
        acc = (x.to(torch.float64) @ w.T).to(torch.int32)  # exact: |acc| < 2**22
    else:
        if op.kind == "stem":
            x = x.expand(*x.shape[:3], op.c_out)
        sr, sc = op.stride, op.stride_cols
        right = max(0, sc * (op.w_out - 1) + 2 - op.w_in)
        xp = F.pad(x, (0, 0, 0, 0, 1, 1), value=op.pad_value)  # the guard rows
        xp = F.pad(xp, (0, 0, 1, right), value=0).to(torch.int32)  # skipped taps add 0
        k = torch.from_numpy(op.weights.astype(np.int32)).to(dev)
        acc = None
        for dh in range(3):
            for dw in range(3):
                xs = xp[:, dh: dh + sr * (op.h_out - 1) + 1: sr,
                        dw: dw + sc * (op.w_out - 1) + 1: sc, :]
                term = xs * k[dh, dw]
                acc = term if acc is None else acc + term
    q = acc + _plane(op, op.d_plane, dev)
    y = _plane(op, op.bias_plane, dev) + _plane(op, op.c1_plane, dev) * f32(q)
    return torch.clamp(round_away(y), op.clip_lo, op.clip_hi).to(torch.int8)


def packed_reference(ops: list, x: torch.Tensor) -> torch.Tensor:
    """The plain torch version of the kernel: int8 [B, H, W, 1] through
    every op of the plan -> int8 [B, h_out, w_out, c_out]."""
    for op in ops:
        x = _op_reference(op, x)
    return x


# --- the device plan ----------------------------------------------------------


def device_ops(graph: Graph, n_layers: int) -> list[FlatOp]:
    """The device plan's ops: the flat kernel's ``FlatOp`` of each of the
    first ``n_layers`` layers (``kernels/flatpack.py::mac_op``), as
    ``plan_flat(graph, max_layers=n_layers)[0]`` gives them wherever the
    flat planner takes the prefix.  Every layer ``plan_packed`` takes is a
    3x3 depthwise conv or a 1x1 conv over at most 128 channels with every
    ``w_zp == 0``, so its ``d`` fits int32 and ``mac_op`` gives its op."""
    ops, shape = [], tuple(graph.input_shape)
    for i, layer in enumerate(graph.layers[:n_layers]):
        ops.append(mac_op(i, layer, shape, tuple(layer.out_shape)))
        shape = ops[-1].out_shape
    return ops


def packed_bound(ops: list, batch: int) -> tuple[int, int]:
    """(bytes, operations) the prefix must move and do at ``batch``: the
    input read once, the output written once, the int8 weights read once;
    2 operations per multiply-add of the true strided outputs."""
    weights = sum(int(op.weights.size) for op in ops)
    last = ops[-1]
    nbytes = batch * (ops[0].h_in * ops[0].w_in + last.h_out * last.w_out * last.c_out) + weights
    return nbytes, 2 * batch * sum(op.macs() for op in ops)


class PackedKernel:
    """``packed_fn``: int8 [B, H, W, 1] -> int8 [B, h_out, w_out, c_out] for
    the ops of ``plan_packed`` (the first ``len(ops)`` layers of ``graph``).
    CUDA tensors launch the kernel on the device plan's buffer (built
    once); CPU tensors run ``packed_reference``.  ``paths`` names each op's
    path in the kernel (``kernels/megakernel.py::op_path``), without a
    card."""

    def __init__(self, graph: Graph, ops: list, device: torch.device):
        self.ops = ops
        self.device = device
        first, last = ops[0], ops[-1]
        self.in_shape = (first.h_in, first.w_in, 1)
        self.out_shape = (last.h_out, last.w_out, last.c_out)
        self.flat_ops = device_ops(graph, len(ops))
        buf, split = pack_plan(self.flat_ops, "exact")
        self.smem_a, self.smem_b = split["smem_a"], split["smem_b"]
        if self.smem_a + self.smem_b > SMEM_BYTES:
            raise ValueError(f"packed: one sample needs {self.smem_a + self.smem_b} bytes of "
                             f"shared memory, more than the {SMEM_BYTES} one block may use")
        n = len(ops)
        # the host copy of the descriptors, which the entry point checks
        self.desc = buf[:n * NF * 4].view(np.int32).reshape(n, NF).copy()
        self.paths = [op_path(row) for row in self.desc]
        self.plan = torch.from_numpy(buf).to(device) if device.type == "cuda" else None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return packed_reference(self.ops, x)
        if x.device.type != "cuda":
            raise ValueError(f"packed: unsupported device {x.device}")
        if self.plan is None or x.device != self.plan.device:
            raise ValueError(f"packed: the plan was built for {self.device}, not {x.device}")
        if (tuple(x.shape[1:]) != self.in_shape or x.dtype != torch.int8
                or not x.is_contiguous()):
            raise ValueError(f"packed: x must be contiguous int8 [B, {self.in_shape}], got "
                             f"{x.dtype} {tuple(x.shape)}")
        b = x.shape[0]
        out = torch.empty((b, *self.out_shape), dtype=torch.int8, device=x.device)
        if b == 0:
            return out
        fn = build.library("packed").mf_packed
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), out.data_ptr(), b, self.plan.data_ptr(), self.desc.ctypes.data,
                    len(self.ops), math.prod(self.in_shape), math.prod(self.out_shape),
                    self.smem_a, self.smem_b, torch.cuda.current_stream().cuda_stream)
        build.check(rc, "packed")
        LAUNCHES["packed"] += 1
        return out


def build_packed_kernel(graph: Graph, max_layers: int | None = None, device=None):
    """Plan the graph's packed prefix and make its kernel for ``device``
    (None means CUDA, which must be present).

    Returns ``(packed_fn, n_layers, meta)``, or None when the graph does
    not pack.  ``packed_fn(x: int8 [B, H, W, 1]) -> int8 [B, h_out, w_out,
    c_out]`` takes any ``B >= 0``.  The weights are baked into the plan at
    build.
    """
    from ..compiler.builder import resolve_device

    device = resolve_device(device)
    plan = plan_packed(graph, max_layers=max_layers)
    if plan is None:
        return None
    ops, n_layers, meta = plan
    return PackedKernel(graph, ops, device), n_layers, meta
