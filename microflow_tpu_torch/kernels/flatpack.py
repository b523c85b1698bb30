"""The whole-network flat kernel (CUDA, ``csrc/flatpack.cu``).

Port of ``microflow_tpu/kernels/flatpack.py::build_flat_kernel``: the
whole flat-packable prefix of a graph in one launch, int8
``[B, in_lanes]`` -> int8 ``[B, out_lanes]``, every intermediate tensor
kept on chip.  One sample is one flat row ``[H*W*C]`` (channels fastest,
as NHWC), so depthwise and pointwise convolutions, any Conv2D,
FullyConnected, AveragePool, Reshape (a pass-through) and Softmax all
read and write plain rows.

The packing rules are the JAX package's (``_pack_prefix``): int8 input;
Conv2D/DepthwiseConv2D with every per-channel ``w_zp == 0`` on a rank-3
input (Conv2D with as many filter channels as input channels) and an
output of at most ``MAX_LANES``; FullyConnected with ``w_zp == 0`` over
the whole flattened sample; AveragePool on a rank-3 input; Softmax over at
most 128 entries; a trailing reshape is dropped, at least two compute ops
pack, and every folded ``d = -in_zp * colsum`` fits in i32.  The TPU
layout machinery (128-lane tap matrices, window clustering, phase offsets,
VPU tap ops) is not carried over: on the card every op reads its input
row in place.  One rule is the port's own: a block holds its sample's
input and output tensors of each op in shared memory (two ping-pong
buffers, each sized to the largest tensor of its parity), so the prefix
stops before an op whose pair would not fit in ``SMEM_BYTES``.  No bundled
or synthetic graph reaches that limit.

Arithmetic per op (exact integers, then the JAX kernel's epilogue in its
association order):

* dw / conv / fc: ``acc = sum over in-bounds taps (x - in_zp) * w`` (the
  TPU kernel's ``acc + d``); a 1x1 conv over a multiple of 4 channels
  ("pw") takes the raw int8 dot plus a per-channel ``d``.  Then
  ``y = bias0[c] + c1[c] * f32(acc)`` (multiply, then add) and
  ``exact2`` = ``clip(trunc(y + (y >= 0 ? 0.5 : -0.5)), lo, hi)``, or
  ``exact`` = ``clip(round_away(y), lo, hi)``; or ``fixed``, the integer
  (M, S) requant of ``core/fixedpoint.py``: ``q = acc + bias_q[c]`` in i32
  (wrapping, as the TPU kernel's ``acc + (d + bias_q)``), ``p = f32(q) *
  m[c]`` with ``m = M * 2**-S``, ``t = trunc(p + (p >= 0 ? 0.5 : -0.5))``,
  then ``clip(t + out_zp, lo, hi)``.  The TPU kernel's measurement-only
  modes (not bit-exact to the reference; they price the epilogue in situ):
  ``raw`` stores the low byte of the JAX plan's accumulator, ``sum over
  in-bounds taps x * w`` (``q`` less the plan's ``d = -in_zp * colsum``),
  wrapped as XLA's i32 -> s8 convert, with no bias, scale, round or clip (a
  pool stores its window sum's low byte); ``noround`` stores
  ``y = bias0 + c1 * f32(acc)`` truncated toward zero, saturating at the
  int8 range (Mosaic's f32 -> int8 convert), with no round and no activation
  clip (a pool keeps its epilogue).
* pool: ``y = c0 * (recip[p] * f32(sum))`` then ``+ c1``, round away,
  clip; the window sum uses true zeros outside the input.
* softmax: ``e = f32(q) * in_s``, ``expf``, the total summed left to
  right over the real entries, ``ex / total / out_s + out_zp``, round
  away, clip to int8.

``exact2`` is not round-half-away at ``y = +-(0.5 - 2**-25)`` (the add
rounds up across the binade); kernel and plain version both compute
``exact2``, as the TPU kernel does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..compiler.ir import (
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    Graph,
    ReshapeLayer,
    SoftmaxLayer,
    chain_length,
)
from ..core.activation import activation_bounds
from ..core.fixedpoint import derive_bias_q, multiplier_scale
from ..core.numerics import broadcast_per_channel, f32, round_away
from ..core.tensor import ViewGeometry, pad_nhwc
from ..ops import softmax
from ..ops.conv_2d import conv_2d_accumulate
from ..ops.depthwise_conv_2d import depthwise_conv_2d_accumulate, window_sum
from ..utils import trace
from . import LAUNCHES, build

LANE = 128  # softmax width limit, the JAX package's one-chunk softmax
MAX_LANES = 65536
# Dynamic shared memory one block may use on an H100 (227 KB).
SMEM_BYTES = 232448
REQUANT_MODES = ("exact2", "exact", "fixed", "raw", "noround")
# F_EXACT of a plan's descriptor: the epilogue of its conv, dw and fc ops
EPILOGUES = {"exact2": 0, "exact": 1, "fixed": 2, "raw": 3, "noround": 4}
# the instantiation of csrc/flatpack.cu's flat_kernel<kMode> that runs each mode
INSTANTIATIONS = {"exact2": "R_EXACT2", "exact": "R_EXACT2", "fixed": "R_FIXED", "raw": "R_RAW",
                  "noround": "R_NOROUND"}

# Op kinds and descriptor layout; csrc/flatpack.cu and csrc/segment_ops.cuh
# read the same numbers.  The megakernel's plan (kernels/megakernel.py) writes
# the same layout; F_WZP, its per-channel weight zero points, is its own.
KINDS = {"dw": 0, "conv": 1, "pw": 2, "fc": 3, "pool": 4, "softmax": 5}
NF = 32  # int32 fields per op descriptor
(F_KIND, F_IH, F_IW, F_IC, F_OH, F_OW, F_OC, F_KH, F_KW, F_SR, F_SC, F_PT, F_PL, F_ZP, F_LO, F_HI,
 F_W, F_D, F_BIAS, F_C1, F_RECIP, F_S0, F_S1, F_OUTZP, F_EXACT, F_IN, F_OUT, F_VEC,
 F_MMA, F_DW3, F_WZP) = range(31)
# F_DW3: the 3x3 depthwise path of an op (csrc/segment_ops.cuh's op_dw3<1>,
# op_dw3<2>, op_dw3_stem), 0 for none
DW3_NONE, DW3_S1, DW3_S2, DW3_STEM = range(4)
THREADS = 256  # threads a block in csrc/segment_ops.cuh
NT = 3  # tiles of 8 pixels a warp's work item in csrc/segment_ops.cuh's op_pw_mma
DW_STRIP = 3  # output pixels a work item of op_dw3
STEM_STRIP = 4  # output pixels a work item of op_dw3_stem


@dataclass
class FlatOp:
    """One op of the plan: shapes, geometry and baked constants."""

    kind: str  # one of KINDS
    layer_idx: int
    in_shape: tuple
    out_shape: tuple
    geom: ViewGeometry | None = None
    in_zp: int = 0
    clip_lo: int = -128  # the activation's bounds within int8
    clip_hi: int = 127
    # dw [KH,KW,C]; conv and pw [F,KH,KW,C]; fc [K,N] (int8)
    weights: np.ndarray | None = None
    bias0: np.ndarray | None = None  # f32 [C_out] = f32(out_zp) + c0
    c1: np.ndarray | None = None  # f32 [C_out]
    # requant "fixed": m = M * 2**-S f32 [C_out], bias_q = round(c0 / c1)
    # int64 [C_out]; bias_q is None where |d + bias_q| reaches 2**31 on some
    # output lane, and the plan then refuses "fixed", as the JAX package does
    m: np.ndarray | None = None
    bias_q: np.ndarray | None = None
    recip: np.ndarray | None = None  # pool: f32 [OH*OW] = 1 / len
    pool_c0: float = 0.0
    pool_c1: float = 0.0
    sm_in_scale: float = 0.0
    sm_out_scale: float = 0.0
    out_zp: int = 0

    @property
    def lanes_in(self) -> int:
        return int(np.prod(self.in_shape))

    @property
    def lanes_out(self) -> int:
        return int(np.prod(self.out_shape))

    def macs(self) -> int:
        """Multiply-adds per sample, every tap of the window counted."""
        if self.kind == "dw":
            return self.lanes_out * self.geom.k_rows * self.geom.k_cols
        if self.kind in ("conv", "pw"):
            return self.lanes_out * int(np.prod(self.weights.shape[1:]))
        if self.kind == "fc":
            return int(self.weights.size)
        return 0


def _pack_prefix(graph: Graph, max_layers):
    """The JAX package's packable layer chain: [(kind, layer, in_shape,
    out_shape)] with kind "conv" (conv, dw, fc), "pool", "skip" or
    "softmax"; None when fewer than two compute ops pack.  It stops before
    the first layer that is not a plain link of a chain (``chain_length``):
    the kernel keeps one activation a row and returns only the last."""
    if np.dtype(graph.input_dtype) != np.int8:
        return None
    in_shape = tuple(graph.input_shape)
    layers = []
    n_convs = 0
    for idx, layer in enumerate(graph.layers[:chain_length(graph)]):
        if max_layers is not None and idx >= max_layers:
            break
        if isinstance(layer, (Conv2DLayer, DepthwiseConv2DLayer)):
            dw = isinstance(layer, DepthwiseConv2DLayer)
            n_ch = layer.weights.shape[2] if dw else layer.filters.shape[0]
            if np.any(broadcast_per_channel(layer.w_q.zero_point, n_ch, np.int64) != 0):
                break
            if len(in_shape) != 3:
                break
            if not dw and layer.filters.shape[3] != in_shape[2]:
                break
            out_shape = (layer.geom.out_rows, layer.geom.out_cols, n_ch)
            if int(np.prod(out_shape)) > MAX_LANES:
                break
            layers.append(("conv", layer, in_shape, out_shape))
            n_convs += 1
        elif isinstance(layer, FullyConnectedLayer):
            if np.any(np.atleast_1d(layer.w_q.zero_point) != 0):
                break
            k, n = layer.weights.shape
            if int(np.prod(in_shape)) != k:
                break
            layers.append(("conv", layer, in_shape, (n,)))
            n_convs += 1
        elif isinstance(layer, AveragePool2DLayer) and len(in_shape) == 3:
            out_shape = (layer.geom.out_rows, layer.geom.out_cols, in_shape[2])
            layers.append(("pool", layer, in_shape, out_shape))
        elif isinstance(layer, ReshapeLayer):
            out_shape = tuple(layer.out_shape)
            if int(np.prod(out_shape)) != int(np.prod(in_shape)):
                break
            layers.append(("skip", layer, in_shape, out_shape))
        elif isinstance(layer, SoftmaxLayer):
            if int(np.prod(in_shape)) > LANE:
                break
            layers.append(("softmax", layer, in_shape, tuple(layer.out_shape)))
        else:
            break
        in_shape = layers[-1][3]
    while layers and layers[-1][0] == "skip":
        layers.pop()
    return layers if n_convs >= 2 else None


def _tap_masks(geom: ViewGeometry, h_in: int, w_in: int):
    """Per tap (dh, dw): the bool [OH, OW] plane of output pixels whose tap
    lies inside the input."""
    top, _, left, _ = geom.pad_amounts()
    rows = np.arange(geom.out_rows) * geom.stride_rows - top
    cols = np.arange(geom.out_cols) * geom.stride_cols - left
    for dh in range(geom.k_rows):
        r_ok = (rows + dh >= 0) & (rows + dh < h_in)
        for dw in range(geom.k_cols):
            c_ok = (cols + dw >= 0) & (cols + dw < w_in)
            yield dh, dw, r_ok[:, None] & c_ok[None, :]


def _colsum(layer, in_shape) -> np.ndarray:
    """int64 sum of the in-bounds weights of every output lane (the TPU
    plan's ``colsum(taps)``)."""
    if isinstance(layer, FullyConnectedLayer):
        return layer.weights.astype(np.int64).sum(axis=0)
    h_in, w_in, _ = in_shape
    geom = layer.geom
    if isinstance(layer, DepthwiseConv2DLayer):
        per_tap = layer.weights.astype(np.int64)  # [KH, KW, C]
    else:
        per_tap = layer.filters.astype(np.int64).sum(axis=3).transpose(1, 2, 0)  # [KH, KW, F]
    colsum = np.zeros((geom.out_rows, geom.out_cols, per_tap.shape[2]), np.int64)
    for dh, dw, ok in _tap_masks(geom, h_in, w_in):
        colsum += ok[:, :, None] * per_tap[dh, dw][None, None, :]
    return colsum


def _smem_split(sizes_out: list, in_lanes: int) -> tuple[int, int]:
    """(A, B) buffer bytes: op i writes buffer A when i is even and B when
    it is odd; the input row is staged in B.  16-byte multiples."""
    a = max(sizes_out[0::2], default=0)
    b = max([in_lanes] + sizes_out[1::2])
    up = lambda v: -(-v // 16) * 16
    return up(a), up(b)


def plan_flat(graph: Graph, max_layers: int | None = None):
    """Plan the maximal flat-packable prefix: ``(ops, n_layers, meta)``, or
    None if fewer than two layers pack.  ``n_layers`` is the JAX package's
    (``plan_flat(graph)[1]``) wherever the shared-memory rule does not
    bind."""
    packed = _pack_prefix(graph, max_layers)
    if packed is None:
        return None
    # the JAX plan's offset search finds no layout for an FC or pool
    # output wider than MAX_LANES, and then nothing packs
    for kind, _layer, _in, out_shape in packed:
        if kind in ("conv", "pool") and int(np.prod(out_shape)) > MAX_LANES:
            return None
    in_lanes = int(np.prod(packed[0][2]))
    ops, n = [], 0
    for idx, (kind, layer, in_shape, out_shape) in enumerate(packed):
        if kind == "skip":
            # a pure reshape: the row is unchanged; the next op's n
            # subsumes it, or it stays in the tail
            continue
        if kind == "softmax":
            op = FlatOp("softmax", idx, in_shape, out_shape,
                        sm_in_scale=float(layer.in_q.scale0),
                        sm_out_scale=float(layer.out_q.scale0), out_zp=layer.out_q.zp0)
        elif kind == "pool":
            op = FlatOp("pool", idx, in_shape, out_shape, geom=layer.geom,
                        pool_c0=float(np.float32(layer.c0)), pool_c1=float(np.float32(layer.c1)))
            op.recip = (np.float32(1.0) / layer.geom.len_plane().astype(np.float32)).reshape(-1)
            op.clip_lo, op.clip_hi = activation_bounds(layer.activation, layer.out_q.scale0,
                                                       layer.out_q.zp0)
        else:
            op = mac_op(idx, layer, in_shape, out_shape)
            if op is None:
                break
        a, b = _smem_split([o.lanes_out for o in ops] + [op.lanes_out], in_lanes)
        if a + b > SMEM_BYTES:
            break  # the port's shared-memory rule (module docstring)
        ops.append(op)
        n = idx + 1
    if n < 2:
        return None
    meta = dict(in_lanes=in_lanes, in_shape=tuple(graph.input_shape),
                out_shape=ops[-1].out_shape, out_lanes=ops[-1].lanes_out)
    return ops, n, meta


def mac_op(idx: int, layer, in_shape: tuple, out_shape: tuple) -> FlatOp | None:
    """The op of a Conv2D, DepthwiseConv2D or FullyConnected layer with
    every ``w_zp == 0`` (kind ``"dw"``, ``"pw"``: a 1x1 conv over a multiple
    of 4 channels, ``"conv"`` or ``"fc"``), its epilogue constants and clip
    bounds; None when ``d = -in_zp * colsum`` leaves int32 on some output
    lane."""
    in_zp = layer.in_q.zp0
    d = -np.int64(in_zp) * _colsum(layer, in_shape)
    if np.any(d != d.astype(np.int32)):
        return None
    c_out = out_shape[-1]
    op = FlatOp("fc", idx, in_shape, out_shape, in_zp=in_zp, out_zp=layer.out_q.zp0)
    if isinstance(layer, DepthwiseConv2DLayer):
        op.kind, op.geom, op.weights = "dw", layer.geom, np.array(layer.weights)
    elif isinstance(layer, Conv2DLayer):
        op.geom = layer.geom
        one = (layer.geom.k_rows, layer.geom.k_cols) == (1, 1)
        op.kind = "pw" if one and in_shape[2] % 4 == 0 else "conv"
        op.weights = np.array(layer.filters)
    else:
        op.weights = np.array(layer.weights)
    op.bias0 = (np.float32(layer.out_q.zp0) + layer.c0.astype(np.float32)).astype(np.float32)
    op.c1 = broadcast_per_channel(layer.c1, c_out, np.float32)
    op.m, op.bias_q = multiplier_scale(op.c1), fixed_bias(layer.c0, op.c1, d)
    op.clip_lo, op.clip_hi = activation_bounds(layer.activation, layer.out_q.scale0,
                                               layer.out_q.zp0)
    return op


def fixed_bias(c0, c1: np.ndarray, d: np.ndarray) -> np.ndarray | None:
    """``bias_q`` per channel (``derive_bias_q``, as the JAX plan computes
    it), int64; None when ``d + bias_q`` leaves i32 on some output lane
    (``d`` per lane, channels last): the JAX plan leaves the fixed planes
    unset then."""
    bias_q = derive_bias_q(np.asarray(c0, np.float32), c1).numpy().astype(np.float64)
    if not np.all(np.abs(d.astype(np.float64) + bias_q) < 2**31):
        return None
    return bias_q.astype(np.int64)


# --- the plain version --------------------------------------------------------


def low_byte(acc: torch.Tensor) -> torch.Tensor:
    """An exact integer's low byte as int8 (the wrapping i32 -> s8 convert)."""
    return (torch.remainder(acc.to(torch.int64) + 128, 256) - 128).to(torch.int8)


def _requant(acc: torch.Tensor, bias0: torch.Tensor, c1: torch.Tensor, lo: int, hi: int,
             requant: str) -> torch.Tensor:
    """``y = bias0 + c1 * f32(acc)`` (multiply, then add), then ``exact2``
    or ``exact``, clipped to the int8 bounds ``[lo, hi]``; or ``noround``,
    ``y`` truncated toward zero within the int8 range, unclipped."""
    y = bias0 + c1 * f32(acc)
    if requant == "noround":
        return torch.trunc(torch.clamp(y, -128, 127)).to(torch.int8)
    if requant == "exact2":
        t = y + torch.where(y >= 0, 0.5, -0.5).to(torch.float32)
        t = torch.trunc(t)
    else:
        t = round_away(y)
    return torch.clamp(t, lo, hi).to(torch.int8)


def _requant_fixed(acc: torch.Tensor, bias_q: torch.Tensor, m: torch.Tensor, out_zp: int,
                   lo: int, hi: int) -> torch.Tensor:
    """The fixed-point epilogue: ``q = acc + bias_q`` in i32 (wrapping),
    ``p = f32(q) * m``, ``t = trunc(p + (p >= 0 ? 0.5 : -0.5))``, then
    ``clip(t + out_zp, lo, hi)``; ``out_zp`` lands after the rounding."""
    q = torch.remainder(acc.to(torch.int64) + bias_q + 2**31, 2**32) - 2**31
    p = f32(q) * m
    t = torch.trunc(p + torch.where(p >= 0, 0.5, -0.5).to(torch.float32))
    y = t + torch.tensor(float(out_zp), dtype=torch.float32, device=acc.device)
    return torch.clamp(y, lo, hi).to(torch.int8)


def _op_reference(op: FlatOp, x: torch.Tensor, requant: str) -> torch.Tensor:
    """One op on [B, lanes_in] -> [B, lanes_out], plain torch: the exact
    accumulators of ``ops/`` (in-bounds taps only, as zero-point padding
    gives), then the kernel's epilogue."""
    dev = x.device
    b = x.shape[0]
    raw = requant == "raw"
    in_zp = 0 if raw else op.in_zp  # raw: the JAX plan's accumulator, q less its d
    if op.kind == "softmax":  # sums left to right, as the kernel
        return softmax(x, in_scale=op.sm_in_scale, out_scale=op.sm_out_scale, out_zp=op.out_zp)
    if op.kind == "fc":
        w = torch.from_numpy(op.weights).to(dev, torch.float64)
        acc = (x.to(torch.float64) - float(in_zp)) @ w
    else:
        x4 = x.reshape(b, *op.in_shape)
        if op.kind == "pool":
            s = window_sum(pad_nhwc(x4, op.geom, 0), None, op.geom)
            if raw:
                return low_byte(s).reshape(b, op.lanes_out)
            recip = torch.from_numpy(op.recip).to(dev).reshape(1, *s.shape[1:3], 1)
            t = recip * f32(s)
            y = (torch.tensor(op.pool_c0, dtype=torch.float32, device=dev) * t
                 + torch.tensor(op.pool_c1, dtype=torch.float32, device=dev))
            y = torch.clamp(round_away(y), op.clip_lo, op.clip_hi)
            return y.to(torch.int8).reshape(b, op.lanes_out)
        w = torch.from_numpy(op.weights).to(dev)
        c_in, c_out = op.in_shape[2], op.out_shape[2]
        no_wzp = np.zeros(c_out, np.int32)
        if op.kind == "dw":
            if c_in not in (1, c_out):  # the channel fallback (1 broadcasts)
                x4 = x4[..., [c if c < c_in else 0 for c in range(c_out)]]
            acc = depthwise_conv_2d_accumulate(x4, w, op.geom, in_zp, no_wzp)
        else:
            acc = conv_2d_accumulate(x4, w, op.geom, in_zp, no_wzp)
        acc = acc.reshape(b, op.lanes_out)
    if raw:
        return low_byte(acc)
    lanes = lambda v: torch.from_numpy(v).to(dev).repeat(op.lanes_out // op.out_shape[-1])
    if requant == "fixed":
        return _requant_fixed(acc, lanes(op.bias_q), lanes(op.m), op.out_zp, op.clip_lo,
                              op.clip_hi)
    return _requant(acc, lanes(op.bias0), lanes(op.c1), op.clip_lo, op.clip_hi, requant)


def flat_forward_reference(ops: list, x2: torch.Tensor, requant: str = "exact2") -> torch.Tensor:
    """The plain torch version of the kernel: int8 [B, in_lanes] through
    every op of the plan -> int8 [B, out_lanes]."""
    x = x2
    for op in ops:
        x = _op_reference(op, x, requant)
    return x


# --- the device plan ----------------------------------------------------------


def _f32_bits(v: float) -> int:
    return int(np.array([v], np.float32).view(np.int32)[0])


class PlanBuffer:
    """A kernel plan as one byte buffer: ``n_ops`` descriptors of ``nf``
    int32 fields (``desc``), then each op's constants, each 16-byte
    aligned; ``put`` returns a constant's offset in bytes from the buffer's
    start.  The whole-network kernels (flatpack, megakernel, packed) read
    their plans so."""

    def __init__(self, n_ops: int, nf: int):
        self.desc = np.zeros((n_ops, nf), np.int32)
        self.chunks = []
        self.offset = n_ops * nf * 4

    def put(self, arr) -> int:
        raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        at, pad = self.offset, (-raw.size) % 16
        self.chunks.append(np.concatenate([raw, np.zeros(pad, np.uint8)]))
        self.offset += raw.size + pad
        return at

    def bytes(self) -> np.ndarray:
        return np.concatenate([self.desc.view(np.uint8).reshape(-1)] + self.chunks)


def pack_plan(ops: list, requant: str = "exact2") -> tuple[np.ndarray, dict]:
    """The plan as one ``PlanBuffer`` of ``NF``-field descriptors for the
    kernel.  Returns the buffer and its shared-memory split.  ``F_EXACT``
    names the epilogue (``EPILOGUES``); under ``"fixed"`` a conv, dw or fc
    op's ``F_BIAS`` words hold ``bias_q`` (i32) and its ``F_C1`` words
    ``m``; under ``"raw"`` every op's ``F_ZP`` and ``d`` are 0, so each path
    sums ``x * w`` over the in-bounds taps, the JAX plan's accumulator."""
    plan = PlanBuffer(len(ops), NF)
    put = plan.put
    for f, op in zip(plan.desc, ops):
        f[F_KIND] = KINDS[op.kind]
        shp_in = op.in_shape if len(op.in_shape) == 3 else (1, 1, op.lanes_in)
        shp_out = op.out_shape if len(op.out_shape) == 3 else (1, 1, op.lanes_out)
        f[F_IH], f[F_IW], f[F_IC] = shp_in
        f[F_OH], f[F_OW], f[F_OC] = shp_out
        f[F_IN], f[F_OUT] = op.lanes_in, op.lanes_out
        if op.geom is not None:
            g = op.geom
            top, _, left, _ = g.pad_amounts()
            f[F_KH], f[F_KW], f[F_SR], f[F_SC], f[F_PT], f[F_PL] = (
                g.k_rows, g.k_cols, g.stride_rows, g.stride_cols, top, left)
        zp = 0 if requant == "raw" else op.in_zp
        f[F_ZP] = zp
        f[F_LO], f[F_HI] = op.clip_lo, op.clip_hi
        f[F_EXACT] = EPILOGUES[requant]
        f[F_OUTZP] = op.out_zp
        if op.kind == "softmax":
            f[F_S0], f[F_S1] = _f32_bits(op.sm_in_scale), _f32_bits(op.sm_out_scale)
            continue
        if op.kind == "pool":
            f[F_S0], f[F_S1] = _f32_bits(op.pool_c0), _f32_bits(op.pool_c1)
            f[F_RECIP] = put(op.recip.astype(np.float32))
            continue
        if op.kind == "pw":
            # every tap of a 1x1 window is in bounds, so d is per filter
            fm, c = op.weights.shape[0], op.weights.shape[3]
            if pw_mma(op.in_shape, op.out_shape):
                f[F_MMA] = 1
                f[F_W] = put(mma_fragments(op.weights.reshape(fm, c)))
            else:
                # [C/4][F] words: word (k, f) packs input channels 4k..4k+3
                # of filter f, so neighbouring threads read neighbouring words
                w = op.weights.reshape(fm, c // 4, 4).transpose(1, 0, 2)
                f[F_W] = put(np.ascontiguousarray(w).view(np.int32).reshape(c // 4, fm))
            f[F_D] = put((-zp * op.weights.reshape(fm, c).astype(np.int64).sum(1))
                         .astype(np.int32))
        elif op.kind == "fc":
            f[F_W] = put(np.ascontiguousarray(op.weights.T).astype(np.int8))  # [N, K]
        elif op.kind == "dw" and (dw3_path(op.geom, op.in_shape, op.out_shape)
                                  or dw_vec(op.in_shape, op.out_shape)):
            f[F_DW3] = dw3_path(op.geom, op.in_shape, op.out_shape)
            f[F_VEC] = int(not f[F_DW3])
            f[F_W] = put(dw3_words(op.weights) if f[F_DW3] else dw_vec_words(op.weights))
            f[F_D] = put(dw_offsets(op.weights, zp).astype(np.int32))
        else:  # dw [KH,KW,C] and conv [F,KH,KW,C], as the layer holds them
            f[F_W] = put(op.weights.astype(np.int8))
        if requant == "fixed":  # bias_q as i32 (mod 2**32: the kernel's sum wraps) and m
            f[F_BIAS] = put(op.bias_q.astype(np.uint32).view(np.int32))
            f[F_C1] = put(op.m.astype(np.float32))
        else:
            f[F_BIAS] = put(op.bias0.astype(np.float32))
            f[F_C1] = put(op.c1.astype(np.float32))
    a, b = _smem_split([op.lanes_out for op in ops], ops[0].lanes_in)
    return plan.bytes(), {"smem_a": a, "smem_b": b}


def dw_vec(in_shape, out_shape) -> bool:
    """Whether the kernels take a depthwise op of these shapes four channels
    a thread (``op_dw_vec``; the 3x3 paths also need it): C a multiple of 4
    whose groups of 4 divide the block, and an input of C or of 1
    channel."""
    c = out_shape[2]
    return c % 4 == 0 and in_shape[2] in (1, c) and THREADS % (c // 4) == 0


def dw3_path(geom: ViewGeometry, in_shape, out_shape) -> int:
    """The kernels' 3x3 depthwise path for a depthwise op of this geometry
    and these shapes (``F_DW3``), a rule on shape fixed in the plan:
    ``DW3_S1``/``DW3_S2`` for a 3x3 window at stride 1 or 2 in both
    directions over as many input as output channels, ``DW3_STEM`` for a
    3x3/s2 depth-multiplier stem (one input channel) with a left padding of
    1 over a row of a multiple of 4 bytes, each with a multiple of 4
    channels whose groups of 4 divide the block and an output of at most
    ``MAX_LANES`` elements; else ``DW3_NONE`` (``op_dw_vec`` or
    ``op_dw``)."""
    if not dw_vec(in_shape, out_shape) or int(np.prod(out_shape)) > MAX_LANES:
        return DW3_NONE
    if (geom.k_rows, geom.k_cols) != (3, 3) or geom.stride_rows != geom.stride_cols:
        return DW3_NONE
    if in_shape[2] == out_shape[2] and geom.stride_rows in (1, 2):
        return DW3_S1 if geom.stride_rows == 1 else DW3_S2
    if geom.stride_rows == 2 and geom.pad_amounts()[2] == 1 and in_shape[1] % 4 == 0:
        return DW3_STEM
    return DW3_NONE


def dw3_words(w: np.ndarray) -> np.ndarray:
    """int8 depthwise taps ``[3, 3, C]`` as the 3x3 path's int32 words
    ``[3][C]``: word (dh, c) packs taps (dh, 0), (dh, 1), (dh, 2) of
    channel c, low byte first, and a 0 high byte."""
    words = np.zeros((3, w.shape[2], 4), np.int8)
    words[:, :, :3] = w.transpose(0, 2, 1)
    return words.view(np.int32).reshape(3, w.shape[2])


def dw_vec_words(w: np.ndarray) -> np.ndarray:
    """int8 depthwise taps ``[KH, KW, C]`` as ``op_dw_vec``'s int32 words
    ``[ceil(T/4)][C]``: word (i, c) packs taps 4i..4i+3 (tap = dh*KW + dw)
    of channel c, zero-padded."""
    kh, kw, c = w.shape
    taps = kh * kw
    wp = np.zeros((-(-taps // 4) * 4, c), np.int8)
    wp[:taps] = w.reshape(taps, c)
    words = np.ascontiguousarray(wp.reshape(-1, 4, c).transpose(0, 2, 1))
    return words.view(np.int32).reshape(-1, c)


def dw_offsets(w: np.ndarray, in_zp: int) -> np.ndarray:
    """int64 ``d[c] = -in_zp * the sum of all of channel c's taps`` of
    depthwise taps ``[KH, KW, C]``: the int8 depthwise paths read ``in_zp``
    for a tap outside the input, and ``d`` removes it again."""
    return -np.int64(in_zp) * w.reshape(-1, w.shape[2]).astype(np.int64).sum(0)


def pw_mma(in_shape, out_shape) -> bool:
    """Whether the kernels take a 1x1 conv of these shapes on the tensor
    cores (``mma.sync`` m16n8k32): a multiple of 4 input channels, a
    multiple of 16 output channels and an output of at most ``MAX_LANES``
    elements.  A rule on shape, fixed in the plan."""
    return in_shape[2] % 4 == 0 and out_shape[2] % 16 == 0 and int(np.prod(out_shape)) <= MAX_LANES


def mma_fragments(w: np.ndarray) -> np.ndarray:
    """int8 weights ``[OC, IC]`` as the kernel's A fragments, int8
    ``[OC/16][ceil(IC/32)][32 lanes][16]``, one A unit (k-step of 32
    channels) after another.  While more than 32 channels remain from
    ``kb``, two units cover ``kb..kb+63``, lane t holding channels
    ``c = kb+16t`` .. ``c+7`` in the first and the next 8 in the second (so
    the kernel reads 16 contiguous bytes of a pixel for both); else one
    unit covers the rest, lane t holding ``c = kb+8t`` .. ``c+7``.  Lane
    4g + t of m-tile m holds row 16m+g channels c..c+3, row 16m+g+8
    c..c+3, row 16m+g c+4..c+7, row 16m+g+8 c+4..c+7 (a0..a3); channels
    >= IC are 0."""
    oc, ic = w.shape
    units = []  # (channel of lane 0, step between lanes)
    for kb in range(0, ic, 64):
        units += [(kb, 16), (kb + 8, 16)] if ic - kb > 32 else [(kb, 8)]
    first = np.array([[kb + step * t for t in range(4)] for kb, step in units])  # [U, 4]
    wp = np.zeros((oc, ic + 64), np.int8)
    wp[:, :ic] = w
    v = wp[:, first[:, :, None] + np.arange(8)]  # [OC, U, t, 8]
    v = v.reshape(oc // 16, 2, 8, len(units), 4, 2, 4)  # [m, row half, g, U, t, c half, 4]
    return np.ascontiguousarray(v.transpose(0, 3, 2, 4, 5, 1, 6)).reshape(-1)


def flat_bound(ops: list, batch: int) -> tuple[int, int]:
    """(bytes, operations) the forward must move and do at ``batch``: the
    input read once, the output written once, the int8 weights read once;
    2 operations per multiply-add, every window tap counted."""
    weights = sum(int(op.weights.size) for op in ops if op.weights is not None)
    nbytes = batch * (ops[0].lanes_in + ops[-1].lanes_out) + weights
    return nbytes, 2 * batch * sum(op.macs() for op in ops)


class FlatKernel:
    """``flat_fn``: int8 [B, in_lanes] -> int8 [B, out_lanes].  CUDA tensors
    launch the kernel on the plan's device buffer (built once); CPU
    tensors run ``flat_forward_reference``.  ``exact2`` and ``exact`` are
    counted as ``flatpack``; ``fixed``, ``raw`` and ``noround`` are each an
    instantiation of their own, counted as ``flatpack_<mode>``."""

    def __init__(self, ops: list, requant: str, device: torch.device):
        self.ops = ops
        self.requant = requant
        self.launch_key = "flatpack" if requant in ("exact2", "exact") else f"flatpack_{requant}"
        self.in_lanes = ops[0].lanes_in
        self.out_lanes = ops[-1].lanes_out
        self.device = device
        self.plan = None
        if device.type == "cuda":
            buf, split = pack_plan(ops, requant)
            self.plan = torch.from_numpy(buf).to(device)
            self.smem_a, self.smem_b = split["smem_a"], split["smem_b"]

    @property
    def paths(self) -> list[str]:
        """Each op's path in the kernel (``kernels/megakernel.py::op_path``),
        from the plan's descriptors, without a card."""
        from .megakernel import op_path

        n = len(self.ops)
        desc = pack_plan(self.ops, self.requant)[0][:n * NF * 4].view(np.int32).reshape(n, NF)
        return [op_path(row, KINDS) for row in desc]

    def __call__(self, x2: torch.Tensor) -> torch.Tensor:
        if x2.device.type == "cpu":
            return flat_forward_reference(self.ops, x2, self.requant)
        if x2.device.type != "cuda":
            raise ValueError(f"flatpack: unsupported device {x2.device}")
        if self.plan is None or x2.device != self.plan.device:
            raise ValueError(f"flatpack: the plan was built for {self.device}, not {x2.device}")
        if (x2.dim() != 2 or x2.shape[1] != self.in_lanes or x2.dtype != torch.int8
                or not x2.is_contiguous()):
            raise ValueError(f"flatpack: x must be contiguous int8 [B, {self.in_lanes}], got "
                             f"{x2.dtype} {tuple(x2.shape)}")
        b = x2.shape[0]
        with trace.Span("mft.flat.launch"):
            out = torch.empty((b, self.out_lanes), dtype=torch.int8, device=x2.device)
            if b == 0:
                return out
            fn = build.library("flatpack").mf_flatpack
            with torch.cuda.device(x2.device):
                rc = fn(x2.data_ptr(), out.data_ptr(), b, self.plan.data_ptr(), len(self.ops),
                        self.in_lanes, self.out_lanes, self.smem_a, self.smem_b,
                        EPILOGUES[self.requant], torch.cuda.current_stream().cuda_stream)
            build.check(rc, "flatpack")
        LAUNCHES[self.launch_key] += 1
        return out


def _check_requant(requant: str) -> None:
    if requant not in REQUANT_MODES:
        raise ValueError(f"unknown requant {requant!r}; choose one of {REQUANT_MODES}")


def kernel_from_plan(plan, requant: str = "exact2", device=None):
    """The kernel of a plan that ``plan_flat`` made: ``(flat_fn, n_layers,
    meta)``, as ``build_flat_kernel`` returns it."""
    from ..compiler.builder import resolve_device

    _check_requant(requant)
    ops, n_layers, meta = plan
    if requant == "fixed":
        for op in ops:
            if op.kind in ("dw", "conv", "pw", "fc") and op.bias_q is None:
                raise ValueError(
                    f"requant='fixed': layer {op.layer_idx}'s d + bias_q leaves int32 on some "
                    "output lane (the JAX package's plan refuses its fixed planes too)")
    return FlatKernel(ops, requant, resolve_device(device)), n_layers, meta


def build_flat_kernel(graph: Graph, max_layers: int | None = None, requant: str = "exact2",
                      device=None):
    """Plan the graph's flat prefix and make its kernel for ``device``
    (None means CUDA, which must be present).

    Returns ``(flat_fn, n_layers, meta)``, with meta keys ``in_lanes``,
    ``in_shape``, ``out_shape``, ``out_lanes``, or None when the graph does
    not pack.  ``flat_fn(x2: int8 [B, in_lanes]) -> int8 [B, out_lanes]``
    takes any ``B >= 0``: no lane padding, no batch tile.  The weights are
    baked into the plan at build.  ``requant`` is ``"exact2"`` (the JAX
    package's default), ``"exact"`` or ``"fixed"`` (the integer (M, S)
    epilogue; a graph whose ``d + bias_q`` leaves int32 raises
    ``ValueError``, where the JAX package returns None), or the
    measurement-only ``"raw"`` and ``"noround"`` (module docstring).
    """
    from ..compiler.builder import resolve_device

    _check_requant(requant)
    device = resolve_device(device)
    plan = plan_flat(graph, max_layers=max_layers)
    return None if plan is None else kernel_from_plan(plan, requant, device)
