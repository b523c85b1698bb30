"""Fused int8 GEMM + requantization + activation (CUDA, ``csrc/qgemm.cu``).

Port of ``microflow_tpu/kernels/qgemm.py::qgemm``.  FullyConnected runs
through it directly and Conv2D after im2col (1x1 convs -- 14 of
person_detect's 31 layers -- are exactly this GEMM):

    acc[m,n] = sum_k X[m,k] * W[k,n]
    q[m,n]   = acc - rowsum(X)[m] * wzp[n] + d[n]          (i32, exact)
    y[m,n]   = roundf(bias0[n] + c1[n] * f32(q))           (f32 mul, then add)
    out      = clip(y, lo, hi) as int8                      (activation bounds)

``d[n] = K * in_zp * wzp[n] - in_zp * colsum(W)[n]`` folds every
zero-point correction into one per-column constant.

The kernel has two paths, chosen by ``qgemm_path`` on shape alone:
``"dp4a"`` (for K < 64 ``qgemm_rows``: a persistent grid whose lanes own
whole rows, read straight into registers, against W and the epilogue
constants staged once a block; the shared-memory tiles of ``qgemm_kernel``
for larger K) and ``"mma"`` (the int8 tensor cores, ``mma.sync``).  Both
compute the same bits.
"""

from __future__ import annotations

import functools

import torch

from ..core.activation import FusedActivation, activation_bounds
from ..core.numerics import f32, round_away
from . import LAUNCHES, build


# The tensor-core path takes K from MMA_MIN_K to MMA_MAX_K (one m-tile's A
# fragments fill the 64 KB a block stages).  Below MMA_MIN_K the narrow
# path (qgemm_rows) beat it at every shape served there, person_detect's
# four and sine's three, timed in one call on one card; at K = 64 the
# tensor cores beat the shared-memory tiles 2.6-2.9x (PERF.md has the
# times).
MMA_MIN_K = 64
MMA_MAX_K = 4096
PATHS = ("dp4a", "mma")  # the C entry point's path argument is the index
_bounds = functools.lru_cache(maxsize=1024)(activation_bounds)  # a per-call host cost


def qgemm_path(M: int, K: int, N: int) -> str:
    """The kernel path of an [M, K] x [K, N] product: ``"mma"`` (the int8
    tensor cores) for ``MMA_MIN_K <= K <= MMA_MAX_K``, else ``"dp4a"``
    (``qgemm_rows`` below ``MMA_MIN_K``, the shared-memory tiles past
    ``MMA_MAX_K``).  A rule on shape (K alone), never on data; ``qgemm``
    launches the path it names."""
    return "mma" if MMA_MIN_K <= K <= MMA_MAX_K else "dp4a"


def requant_clip(q: torch.Tensor, bias0: torch.Tensor, c1: torch.Tensor, lo: int, hi: int):
    """Plain epilogue shared by the kernels' reference versions:
    ``clip(roundf(bias0 + c1 * f32(q)), lo, hi)`` as int8, the multiply
    and the add rounded separately."""
    y = round_away(bias0 + c1 * f32(q))
    return torch.clamp(y, lo, hi).to(torch.int8)


def qgemm_reference(
    x: torch.Tensor, w: torch.Tensor, wzp: torch.Tensor, d: torch.Tensor,
    bias0: torch.Tensor, c1: torch.Tensor, *,
    activation: FusedActivation, out_scale: float, out_zp: int,
) -> torch.Tensor:
    """The plain torch version of the kernel; the product is float64,
    exact while |acc| < 2**53."""
    x64 = x.to(torch.float64)
    acc = x64 @ w.to(torch.float64)
    rowsum = x64.sum(dim=1, keepdim=True)
    q = acc - rowsum * wzp.to(torch.float64)[None, :] + d.to(torch.float64)[None, :]
    lo, hi = activation_bounds(activation, out_scale, out_zp)
    return requant_clip(q, bias0.to(torch.float32)[None, :], c1.to(torch.float32)[None, :], lo, hi)


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"qgemm: {what} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"qgemm: {what} must be contiguous")


def qgemm(
    x: torch.Tensor,  # [M, K] int8
    w: torch.Tensor,  # [K, N] int8
    wzp: torch.Tensor,  # [N] i32 per-column weight zero points
    d: torch.Tensor,  # [N] i32 folded zero-point correction
    bias0: torch.Tensor,  # [N] f32 = out_zp + C0
    c1: torch.Tensor,  # [N] f32 requant multipliers
    *,
    activation: FusedActivation,
    out_scale: float,
    out_zp: int,
    path: str | None = None,
) -> torch.Tensor:
    """int8 [M, N].  CUDA tensors launch the kernel on ``path`` (default
    ``qgemm_path(M, K, N)``; naming one is for measurement); CPU tensors run
    ``qgemm_reference``."""
    if path is not None and (path not in PATHS or (path == "mma" and x.shape[-1] > MMA_MAX_K)):
        raise ValueError(f"qgemm: no path {path!r} for K = {x.shape[-1]}")
    if x.device.type == "cpu":
        return qgemm_reference(x, w, wzp, d, bias0, c1, activation=activation,
                               out_scale=out_scale, out_zp=out_zp)
    if x.device.type != "cuda":
        raise ValueError(f"qgemm: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"qgemm: x must be 2-D, got {tuple(x.shape)}")
    M, K = x.shape
    N = w.shape[1] if w.dim() == 2 else -1
    _check(x, "x", torch.int8, (M, K), x.device)
    _check(w, "w", torch.int8, (K, N), x.device)
    for t, what, dt in ((wzp, "wzp", torch.int32), (d, "d", torch.int32),
                        (bias0, "bias0", torch.float32), (c1, "c1", torch.float32)):
        _check(t, what, dt, (N,), x.device)
    path = qgemm_path(M, K, N) if path is None else path
    out = torch.empty((M, N), dtype=torch.int8, device=x.device)
    if M == 0:
        return out
    lo, hi = _bounds(activation, out_scale, out_zp)
    fn = build.library("qgemm").mf_qgemm
    vec_x = int(K % 4 == 0 and x.data_ptr() % 4 == 0)
    vec_out = int(N % 4 == 0 and out.data_ptr() % 4 == 0)
    rc = build.launch(fn, x.device, x.data_ptr(), w.data_ptr(), wzp.data_ptr(), d.data_ptr(),
                      bias0.data_ptr(), c1.data_ptr(), out.data_ptr(), M, K, N, float(lo),
                      float(hi), vec_x, vec_out, PATHS.index(path))
    build.check(rc, "qgemm")
    LAUNCHES["qgemm"] += 1
    return out
