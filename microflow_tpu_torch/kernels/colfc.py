"""The column-FC kernel for tiny FullyConnected chains (CUDA,
``csrc/colfc.cu``).

Port of ``microflow_tpu/kernels/colfc.py::build_col_kernel``, the JAX
package's experimental ``colfc`` backend (sine: 1 -> 16 -> 16 -> 1).  The
TPU kernel put the batch on the vector lanes; on the card the samples go
on the M of the int8 tensor cores' ``mma.sync`` (16 a tile) and the
features on its N, one instruction per 16 samples and 8 features of a
layer, and each layer's accumulators become the next layer's A fragment in
registers (``pack_col_plan`` permutes the next layer's rows of W to match).
Every layer is a FullyConnected with ``w_zp == 0`` and both dims at most
32, so ``q = acc + d`` with ``d = -in_zp * colsum(W)``, then the ``exact2``
epilogue of the flat kernel (``kernels/flatpack.py``).  The weights are
baked into the plan at build.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..compiler.ir import FullyConnectedLayer, Graph, chain_length
from ..core.activation import activation_bounds
from . import LAUNCHES, build
from .flatpack import SMEM_BYTES, _f32_bits, _requant

MAX_WIDTH = 32  # feature widths beyond this are not a tiny chain
HEADER = 4  # int32 words per layer header in the packed plan (csrc/colfc.cu kHeader)
NARROW_OUT = 2  # N_out up to which the last layer's columns repeat (csrc/colfc.cu kNarrowOut)


def plan_col(graph: Graph, max_width: int = MAX_WIDTH):
    """The column plan: every layer a FullyConnected with w_zp == 0 and
    both dims <= max_width.  Returns [(W_T i32 [N,K], d [N,1] i32,
    bias0 [N,1] f32, c1 [N,1] f32, clip_lo, clip_hi)] or None (also for a
    graph that is not one chain, ``chain_length``)."""
    if np.dtype(graph.input_dtype) != np.int8 or chain_length(graph) != len(graph.layers):
        return None
    k0 = int(np.prod(graph.input_shape))
    if k0 > max_width:
        return None
    plan = []
    k_in = k0
    for layer in graph.layers:
        if not isinstance(layer, FullyConnectedLayer):
            return None
        if np.any(np.atleast_1d(layer.w_q.zero_point) != 0):
            return None
        k, n = layer.weights.shape
        if k != k_in or n > max_width or k > max_width:
            return None
        w = layer.weights.astype(np.int64)
        d = (-np.int64(layer.in_q.zp0) * w.sum(axis=0)).astype(np.int64)
        if np.any(d != d.astype(np.int32)):
            return None
        bias0 = (np.float32(layer.out_q.zp0) + layer.c0.astype(np.float32)).reshape(n, 1)
        c1 = (np.full((n, 1), np.float32(layer.c1), np.float32) if np.ndim(layer.c1) == 0
              else np.asarray(layer.c1, np.float32).reshape(n, 1))
        lo, hi = activation_bounds(layer.activation, layer.out_q.scale0, layer.out_q.zp0)
        plan.append((layer.weights.T.astype(np.int32), d.astype(np.int32).reshape(n, 1),
                     bias0.astype(np.float32), c1.astype(np.float32), lo, hi))
        k_in = n
    return plan if len(plan) >= 1 else None


def f32_exact(plan) -> bool:
    """Whether every partial sum of every layer, the ``d`` seed included,
    stays inside f32's exact-integer range (< 2**24).  Activations reach
    -128, so the bound is 128 * sum|w| (the JAX package's 127 misses the
    -128 input; ROADMAP.md queue C)."""
    for wt, d, *_ in plan:
        worst = 128 * int(np.abs(wt.astype(np.int64)).sum(axis=1).max()) + int(np.abs(d).max())
        if worst >= 2**24:
            return False
    return True


def colfc_reference(plan, x: torch.Tensor) -> torch.Tensor:
    """The plain torch version of the kernel: int8 [B, K0] -> int8
    [B, N_out].  The product is float64, exact; the epilogue is ``exact2``
    (``bias0 + c1 * f32(acc)``, multiply then add, then
    ``trunc(y + (y >= 0 ? 0.5 : -0.5))`` clipped)."""
    dev = x.device
    for wt, d, b0, c1, lo, hi in plan:
        acc = x.to(torch.float64) @ torch.from_numpy(wt).to(dev, torch.float64).T
        acc = acc + torch.from_numpy(d[:, 0]).to(dev, torch.float64)
        x = _requant(acc, torch.from_numpy(b0[:, 0]).to(dev), torch.from_numpy(c1[:, 0]).to(dev),
                     lo, hi, "exact2")
    return x


def feature_order() -> np.ndarray:
    """pi: the feature that A position p (0..31) of layer l+1 holds when the
    kernel packs layer l's C fragments into it.  Lane 4g+t holds columns
    8j+2t and 8j+2t+1 of n-tile j; the odd n-tile of each pair fills A
    positions 4t, 4t+1 and the even one 4t+2, 4t+3 (n-tiles 0-1 in the
    lower half of K, 2-3 in the upper), so pi(4t+i) = 2t + i%2 + 8*(i < 2)
    (+16 in the upper half)."""
    p = np.arange(32)
    i = p % 4
    return 16 * (p // 16) + 2 * ((p % 16) // 4) + i % 2 + 8 * (i < 2)


def pack_col_plan(plan) -> np.ndarray:
    """The plan as one int32 buffer, as ``csrc/colfc.cu`` reads it: per layer
    a header (n-tiles ``nt = ceil(N / 8)``, lo and hi as f32 bits, the
    offset of its data in words), then per layer its data: the B fragments
    of ``mma.sync`` m16n8k32, ``[nt][32 lanes][2 words]`` (lane 4g+t: word
    0 holds K positions 4t..4t+3 of column 8j+g, word 1 positions
    16+4t..16+4t+3), then ``d``, ``bias0`` and ``c1``, each ``[nt][8]``,
    zero past N.  Layer 0's K positions are its inputs in order; a later
    layer's are permuted by ``feature_order`` and zero past its K.  A last
    layer of N <= ``NARROW_OUT`` has its N columns repeated over its 8
    (column c is column c % N), for the kernel's one epilogue a lane.  The
    same buffer serves both ``compute`` modes."""
    n_layers = len(plan)
    header = np.zeros((n_layers, HEADER), np.int32)
    data, off = [], n_layers * HEADER
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    # the K position of byte b of a lane's two B words
    kpos = np.concatenate([4 * t[:, None] + np.arange(4), 16 + 4 * t[:, None] + np.arange(4)], 1)
    for i, (wt, d, b0, c1, lo, hi) in enumerate(plan):
        n, k = wt.shape
        nt = -(-n // 8)
        # the column each of the 8 * nt holds; past N none, or N's repeated
        cols = np.arange(8 * nt)
        cols = cols % n if i == n_layers - 1 and n <= NARROW_OUT else np.where(cols < n, cols, -1)
        feature = feature_order() if i else np.arange(32)
        w = np.zeros((32, 8 * nt), np.int64)  # [K position, column]
        live = feature < k
        w[np.ix_(live, cols >= 0)] = wt.T[np.ix_(feature[live], cols[cols >= 0])]
        frag = w[kpos[None], 8 * np.arange(nt)[:, None, None] + g[None, :, None]]
        consts = [np.zeros(8 * nt, np.int32), np.zeros(8 * nt, np.float32),
                  np.zeros(8 * nt, np.float32)]
        for arr, src in zip(consts, (d, b0, c1)):
            arr[cols >= 0] = src[cols[cols >= 0], 0]
        header[i] = (nt, _f32_bits(lo), _f32_bits(hi), off)
        for arr in (frag.astype(np.int8).reshape(-1).view(np.int32), *consts):
            data.append(arr.view(np.int32))
            off += arr.size
    return np.concatenate([header.reshape(-1)] + data)


class ColKernel:
    """``col_fn``: int8 [B, K0] -> int8 [B, N_out].  CUDA tensors launch the
    kernel on the packed plan's device buffer (``pack_col_plan``, uploaded
    once); CPU tensors run
    ``colfc_reference``.  The kernel's entry point is looked up at the
    first launch and kept."""

    def __init__(self, plan, packed: np.ndarray, compute: str, device: torch.device):
        self.plan = plan
        self.compute = compute
        self.k0 = plan[0][0].shape[1]
        self.n_out = plan[-1][0].shape[0]
        self.device = device
        self.buf = None
        self._fn = None
        if device.type == "cuda":
            self.buf = torch.from_numpy(packed).to(device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return colfc_reference(self.plan, x)
        if x.device.type != "cuda":
            raise ValueError(f"colfc: unsupported device {x.device}")
        if self.buf is None or x.device != self.buf.device:
            raise ValueError(f"colfc: the plan was built for {self.device}, not {x.device}")
        if (x.dim() != 2 or x.shape[1] != self.k0 or x.dtype != torch.int8
                or not x.is_contiguous()):
            raise ValueError(f"colfc: x must be contiguous int8 [B, {self.k0}], got "
                             f"{x.dtype} {tuple(x.shape)}")
        b = x.shape[0]
        out = torch.empty((b, self.n_out), dtype=torch.int8, device=x.device)
        if b == 0:
            return out
        if self._fn is None:
            self._fn = build.library("colfc").mf_colfc
        with (contextlib.nullcontext() if x.device.index == torch.cuda.current_device()
              else torch.cuda.device(x.device)):
            rc = self._fn(x.data_ptr(), out.data_ptr(), b, self.buf.data_ptr(), len(self.plan),
                          self.buf.numel(), self.k0, self.n_out,
                          torch.cuda.current_stream().cuda_stream)
        build.check(rc, "colfc")
        LAUNCHES["colfc"] += 1
        return out


def build_col_kernel(graph: Graph, compute: str = "i32", device=None):
    """Plan the chain and make its kernel for ``device`` (None means CUDA,
    which must be present).  Returns ``(col_fn, meta)`` with meta keys
    ``k0``, ``n_out`` and ``compute`` (the mode in use), or None when the
    graph is not a tiny FC chain or
    its plan does not fit one block's shared memory.  ``col_fn`` takes any
    batch: no transposes, no batch tile.

    ``compute``: ``"i32"`` accumulates in integers; ``"f32"`` in f32, which
    is exact, and so gives the same bits, while every partial sum stays
    below 2**24 -- otherwise it falls back to ``"i32"``.  The mode is the
    JAX package's and is kept in ``meta``; on the card both run the one s32
    tensor-core path, whose bits are the same, and the CPU's plain version
    is exact in float64 either way."""
    if compute not in ("f32", "i32"):
        raise ValueError(f"compute {compute!r}")
    from ..compiler.builder import resolve_device

    device = resolve_device(device)
    plan = plan_col(graph)
    if plan is None:
        return None
    if compute == "f32" and not f32_exact(plan):
        compute = "i32"
    packed = pack_col_plan(plan)
    if packed.nbytes > SMEM_BYTES:
        return None
    col_fn = ColKernel(plan, packed, compute, device)
    return col_fn, dict(k0=col_fn.k0, n_out=col_fn.n_out, compute=compute)
