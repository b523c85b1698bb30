"""Fused int8 depthwise conv + requantization + activation (CUDA,
``csrc/qdwconv.cu``).

Port of ``microflow_tpu/kernels/qdwconv.py::qdwconv``, with one change of
interface: the input arrives unpadded, and ``in_zp`` stands for every tap
outside it (the JAX kernel takes the input already padded with
``in_zp``).  The weights arrive centred (``w - w_zp``, i32), so the only
correction left is ``d[c] = -in_zp * sum_mn wc[m,n,c]``:

    q[b,i,j,c] = sum_mn x_zp[b, sr*i+m-pad_top, sc*j+n-pad_left, c] * wc[m,n,c] + d[c]
    y = roundf(bias0[c] + c1[c] * f32(q)), clipped to the activation bounds

``x`` has C channels or one (the depth-multiplier stem: every output
channel reads input channel 0).  ``plan`` picks the kernel's path and, for
the 3x3 tile paths, the shape of a block's tile.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.activation import FusedActivation, activation_bounds
from ..core.tensor import ViewGeometry, ViewPadding
from . import LAUNCHES, build
from .qgemm import requant_clip

# the kernel's paths (csrc/qdwconv.cu)
PATH_GENERAL, PATH_S1, PATH_S2, PATH_STEM = range(4)
PATH_NAMES = ("general", "3x3/s1", "3x3/s2", "stem")
THREADS = 256  # threads a block, at most
MAX_TILE = 48 * 1024  # shared-memory bytes a block
ITEMS_PER_THREAD = 3  # work items a tile aims to give each thread


class Plan(NamedTuple):
    """How ``qdwconv`` launches.  ``vec``: on the general path the channels
    a thread (4 or 1); on a tile path the bytes a staging unit (16, 4, or 1
    for words put together byte by byte).  The tile paths' blocks take
    ``samples`` samples by a band of ``rows`` output rows and stage
    ``staged_rows`` input rows a sample, each ``pitch`` bytes whose byte
    ``margin`` holds input column 0; a work item is a strip of ``strip``
    output pixels of one row for one group of 4 channels."""

    path: int
    vec: int
    strip: int = 0
    rows: int = 0
    samples: int = 0
    staged_rows: int = 0
    margin: int = 0
    pitch: int = 0
    threads: int = THREADS
    blocks: int = 0


_bounds = functools.lru_cache(maxsize=1024)(activation_bounds)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=1024)  # a per-call host cost: every forward asks again
def plan(B: int, H: int, W: int, cin: int, C: int, *, kh: int, kw: int, sr: int, sc: int,
         pad_top: int, pad_left: int, oh: int, ow: int, int8_taps: bool,
         x_align: int = 16) -> Plan:
    """The launch of one call (``x_align``: the largest of 16, 4, 1 that
    divides the input's address).  The tile paths take 3x3 windows at
    stride 1 or 2 over a multiple of 4 channels (at most 1024), input with
    C channels, or the stride-2 stem (one input channel, left padding 1),
    whose centred weights fit int8 (``int8_taps``: the caller knows it
    from the model, every weight zero point 0).  Everything else, or a tile
    whose smallest band does not fit shared memory, takes the general
    path."""
    row_bytes = W * cin
    general = Plan(PATH_GENERAL, 4 if C % 4 == 0 and (cin == 1 or x_align % 4 == 0) else 1)
    stem = cin == 1 and C > 1
    if not (int8_taps and kh == kw == 3 and sr == sc and sr in (1, 2) and C % 4 == 0
            and C <= 4 * THREADS and pad_top < 3 and pad_left < 3
            and (cin == C or (stem and sr == 2 and pad_left == 1))):
        return general
    path = PATH_STEM if stem else (PATH_S1 if sr == 1 else PATH_S2)
    groups = C // 4
    slots = THREADS // groups  # work items a block takes at a time
    strip = 4 if stem else 3
    ns = -(-ow // strip)
    if stem:  # a strip's three words: columns 8s-4 .. 8s+7
        margin, reach = 16, 8 * ns
    else:
        nx = strip + 2 if sr == 1 else 2 * strip + 1
        margin = _round16(pad_left * C)
        reach = ((ns - 1) * strip * sr + nx - pad_left) * C
    pitch = _round16(margin + max(row_bytes, reach))
    staged = lambda rows: (rows - 1) * sr + 3
    target = ITEMS_PER_THREAD * slots
    if oh * ns >= 2 * slots:
        samples, bands = 1, max(1, (oh * ns + target // 2) // target)
        rows = -(-oh // bands)
    else:
        samples, rows = max(1, min(B, (target + oh * ns // 2) // (oh * ns))), oh
    while samples * staged(rows) * pitch > MAX_TILE:
        if samples > 1:
            samples -= 1
        elif rows > 1:
            rows -= 1
        else:
            return general
    vec = next(v for v in (16, 4, 1) if row_bytes % v == 0 and x_align % v == 0)
    return Plan(path, vec, strip, rows, samples, staged(rows), margin, pitch,
                (THREADS // groups) * groups, -(-B // samples) * -(-oh // rows))


def zp_padded(x: torch.Tensor, c: int, *, in_zp: int, pad_top: int, pad_left: int, kh: int,
              kw: int, sr: int, sc: int, oh: int, ow: int) -> torch.Tensor:
    """``x`` [B, H, W, 1 or C] as the JAX kernel takes it: [B, HP, WP, C],
    padded with ``in_zp`` so that every window lies inside, the stem's one
    channel broadcast to all C."""
    B, H, W, cin = x.shape
    bottom = max(0, sr * (oh - 1) + kh - pad_top - H)
    right = max(0, sc * (ow - 1) + kw - pad_left - W)
    if cin != c:
        x = x.expand(B, H, W, c)
    return F.pad(x, (0, 0, pad_left, right, pad_top, bottom), value=int(in_zp))


def qdwconv_reference(
    x: torch.Tensor, wc: torch.Tensor, d: torch.Tensor, bias0: torch.Tensor, c1: torch.Tensor,
    *, in_zp: int, pad_top: int, pad_left: int, kh: int, kw: int, sr: int, sc: int, oh: int,
    ow: int, activation: FusedActivation, out_scale: float, out_zp: int, int8_taps: bool = False,
) -> torch.Tensor:
    """The plain torch version of the kernel: the ``in_zp``-padded input,
    KH*KW shifted int32 products, exact.  ``int8_taps`` changes nothing
    here."""
    from ..ops.depthwise_conv_2d import window_sum

    xp = zp_padded(x, wc.shape[2], in_zp=in_zp, pad_top=pad_top, pad_left=pad_left, kh=kh,
                   kw=kw, sr=sr, sc=sc, oh=oh, ow=ow)
    geom = ViewGeometry(in_rows=xp.shape[1], in_cols=xp.shape[2], k_rows=kh, k_cols=kw,
                        out_rows=oh, out_cols=ow, stride_rows=sr, stride_cols=sc,
                        padding=ViewPadding.VALID)
    q = window_sum(xp, wc.to(torch.int32), geom) + d.to(torch.int32)
    lo, hi = activation_bounds(activation, out_scale, out_zp)
    return requant_clip(q, bias0.to(torch.float32), c1.to(torch.float32), lo, hi)


def qdwconv(
    x: torch.Tensor,  # [B, H, W, C or 1] int8, unpadded
    wc: torch.Tensor,  # [KH, KW, C] i32 centred weights (w - w_zp)
    d: torch.Tensor,  # [C] i32 = -in_zp * sum(wc)
    bias0: torch.Tensor,  # [C] f32
    c1: torch.Tensor,  # [C] f32
    *,
    in_zp: int, pad_top: int, pad_left: int,
    kh: int, kw: int, sr: int, sc: int, oh: int, ow: int,
    activation: FusedActivation,
    out_scale: float,
    out_zp: int,
    int8_taps: bool = False,
) -> torch.Tensor:
    """int8 [B, OH, OW, C].  CUDA tensors launch the kernel; CPU tensors
    run ``qdwconv_reference``.  ``int8_taps`` promises that every entry of
    ``wc`` lies in [-128, 127] (so when every weight zero point is 0),
    which the 3x3 tile paths need; nothing checks it on the card."""
    kw_args = dict(in_zp=in_zp, pad_top=pad_top, pad_left=pad_left, kh=kh, kw=kw, sr=sr, sc=sc,
                   oh=oh, ow=ow, activation=activation, out_scale=out_scale, out_zp=out_zp)
    if x.device.type == "cpu":
        return qdwconv_reference(x, wc, d, bias0, c1, **kw_args)
    if x.device.type != "cuda":
        raise ValueError(f"qdwconv: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype != torch.int8 or not x.is_contiguous():
        raise ValueError(f"qdwconv: x must be contiguous int8 [B,H,W,C], got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, H, W, cin = x.shape
    C = wc.shape[-1] if wc.dim() == 3 else -1
    if cin not in (1, C):
        raise ValueError(f"qdwconv: x has {cin} channels, the weights {C}")
    if not (0 <= pad_top < kh and 0 <= pad_left < kw and oh > 0 and ow > 0 and sr > 0 and sc > 0
            and -128 <= in_zp <= 127):
        raise ValueError(f"qdwconv: bad geometry pads ({pad_top}, {pad_left}), window "
                         f"{kh}x{kw}/({sr},{sc}), output {oh}x{ow}, in_zp {in_zp}")
    for t, what, dt, shape in ((wc, "wc", torch.int32, (kh, kw, C)), (d, "d", torch.int32, (C,)),
                               (bias0, "bias0", torch.float32, (C,)),
                               (c1, "c1", torch.float32, (C,))):
        if (t.dtype != dt or tuple(t.shape) != shape or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"qdwconv: {what} must be contiguous {dt} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((B, oh, ow, C), dtype=torch.int8, device=x.device)
    if B == 0:
        return out
    lo, hi = _bounds(activation, out_scale, out_zp)
    p = plan(B, H, W, cin, C, kh=kh, kw=kw, sr=sr, sc=sc, pad_top=pad_top, pad_left=pad_left,
             oh=oh, ow=ow, int8_taps=int8_taps,
             x_align=next(a for a in (16, 4, 1) if x.data_ptr() % a == 0))
    if p.path != PATH_GENERAL and any(t.data_ptr() % 16 for t in (wc, d, bias0, c1)):
        p = Plan(PATH_GENERAL, 4 if C % 4 == 0 and (cin == 1 or x.data_ptr() % 4 == 0) else 1)
    if p.path == PATH_GENERAL and p.vec == 4 and wc.data_ptr() % 16:
        p = p._replace(vec=1)
    fn = build.library("qdwconv").mf_qdwconv
    rc = build.launch(fn, x.device, x.data_ptr(), wc.data_ptr(), d.data_ptr(), bias0.data_ptr(),
                      c1.data_ptr(), out.data_ptr(), B, H, W, cin, C, kh, kw, sr, sc, pad_top,
                      pad_left, oh, ow, int(in_zp), float(lo), float(hi), p.path, p.vec, p.rows,
                      p.samples, p.margin, p.pitch)
    build.check(rc, "qdwconv")
    LAUNCHES["qdwconv"] += 1
    return out
