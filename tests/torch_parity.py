"""Parity helpers for the torch port's tests (``tests/test_torch_*.py``).

The rule the port is held to: its output equals the JAX package's bit for
bit, except where the JAX reference, run by XLA on the CPU, contracts the
requant epilogue ``add + a*b`` into one fused multiply-add and so rounds to
another integer than the reference's multiply-then-add.  Those elements
are computed here from the exact integer accumulator in numpy, with the
fused multiply-add emulated in float64 (the product of two f32 values is
exact there).  On them the port must give the multiply-then-add result;
everywhere else it must equal the JAX output.  Softmax may differ by one
LSB (``expf`` ULPs and summation order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from microflow_tpu.compiler import builder as jbuilder
from microflow_tpu.compiler.ir import (
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    SoftmaxLayer,
)
from microflow_tpu.core.activation import FusedActivation, quantize_scalar
from microflow_tpu_torch.compiler import builder as tbuilder

F32 = np.float32


def round_away(y: np.ndarray) -> np.ndarray:
    t = np.trunc(y)
    return t + np.sign(y) * (np.abs(y - t) >= 0.5)


def bounds(activation, out_scale, out_zp, dtype) -> tuple[int, int]:
    info = np.iinfo(dtype)
    lo, hi = info.min, info.max
    if activation in (FusedActivation.RELU, FusedActivation.RELU6):
        lo = max(lo, int(out_zp))
    if activation is FusedActivation.RELU6:
        hi = min(hi, quantize_scalar(6.0, out_scale, out_zp, dtype))
    return lo, hi


def epilogue_pair(a, b, add, lo, hi):
    """Integer outputs of ``clip(roundf(add + a*b))`` computed as a multiply
    then an add (the reference) and as one fused multiply-add."""
    a, b, add = (np.asarray(v, F32) for v in (a, b, add))
    sep = (add + (a * b).astype(F32)).astype(F32)
    fma = (add.astype(np.float64) + a.astype(np.float64) * b.astype(np.float64)).astype(F32)
    return (np.clip(round_away(sep), lo, hi).astype(np.int64),
            np.clip(round_away(fma), lo, hi).astype(np.int64))


def assert_fma_rule(port: np.ndarray, ref: np.ndarray, sep: np.ndarray, fma: np.ndarray,
                    what: str = "") -> int:
    """Port equals the reference outside the FMA-sensitive set and the
    multiply-then-add result on it.  Returns the set's size."""
    port = np.asarray(port).astype(np.int64)
    ref = np.asarray(ref).astype(np.int64)
    assert port.shape == ref.shape == sep.shape, (what, port.shape, ref.shape, sep.shape)
    sens = sep != fma
    outside = ~sens
    bad = np.nonzero(outside & (port != ref))
    assert bad[0].size == 0, (
        f"{what}: {bad[0].size} elements differ outside the FMA set, e.g. at "
        f"{[int(i[0]) for i in bad]}: port {port[bad][:5]} vs reference {ref[bad][:5]}")
    assert np.array_equal(port[sens], sep[sens]), f"{what}: port is not multiply-then-add"
    return int(sens.sum())


def _per_channel(values, n, dtype):
    return np.array([values[i] if i < len(values) else values[0] for i in range(n)], dtype)


def _patches(x: np.ndarray, geom, pad_value: int) -> np.ndarray:
    """[B,H,W,C] -> [B,OH,OW,KH,KW,C] with the reference's padding."""
    top, bottom, left, right = geom.pad_amounts()
    xp = np.pad(x.astype(np.int64), ((0, 0), (top, bottom), (left, right), (0, 0)),
                constant_values=pad_value)
    out = np.empty((x.shape[0], geom.out_rows, geom.out_cols, geom.k_rows, geom.k_cols,
                    x.shape[3]), np.int64)
    for m in range(geom.k_rows):
        for n in range(geom.k_cols):
            out[:, :, :, m, n, :] = xp[:, m::geom.stride_rows, n::geom.stride_cols, :][
                :, :geom.out_rows, :geom.out_cols, :]
    return out


def expected_pair(layer, params: dict, x: np.ndarray):
    """(multiply-then-add, fused) integer outputs of a requantizing layer,
    from its exact accumulator; None for layers without that epilogue."""
    dtype = np.dtype(x.dtype)
    if isinstance(layer, (FullyConnectedLayer, Conv2DLayer, DepthwiseConv2DLayer)):
        p = {k: np.asarray(v) for k, v in params[f"layer{layer.index}"].items()}
        lo, hi = bounds(layer.activation, layer.out_q.scale0, layer.out_q.zp0, dtype)
        bias0 = F32(layer.out_q.zp0) + p["c0"].astype(F32)
        in_zp = layer.in_q.zp0
        if isinstance(layer, FullyConnectedLayer):
            x2 = x.reshape(x.shape[0], -1).astype(np.int64)
            w = p["weights"].astype(np.int64)
            q = (x2 @ w - x2.sum(1, keepdims=True) * layer.w_q.zp0
                 - p["c2"].astype(np.int64)[None, :] + layer.c3)
            c1 = np.full(q.shape[1], layer.c1, F32)
        elif isinstance(layer, Conv2DLayer):
            nf = layer.filters.shape[0]
            wzp = _per_channel(layer.w_q.zero_point, nf, np.int64)
            wc = p["weights"].astype(np.int64) - wzp[:, None, None, None]
            pt = _patches(x, layer.geom, in_zp) - in_zp
            q = np.einsum("bijmnc,fmnc->bijf", pt, wc)
            c1 = _per_channel(layer.c1, nf, F32)
        else:
            ch = layer.weights.shape[2]
            in_c = x.shape[-1]
            xs = x[..., [c if c < in_c else 0 for c in range(ch)]]
            wzp = _per_channel(layer.w_q.zero_point, ch, np.int64)
            wc = p["weights"].astype(np.int64) - wzp[None, None, :]
            pt = _patches(xs, layer.geom, in_zp) - in_zp
            q = np.einsum("bijmnc,mnc->bijc", pt, wc)
            c1 = _per_channel(layer.c1, ch, F32)
        return epilogue_pair(c1, q.astype(F32), bias0, lo, hi)
    if isinstance(layer, AveragePool2DLayer):
        lo, hi = bounds(layer.activation, layer.out_q.scale0, layer.out_q.zp0, dtype)
        s = _patches(x, layer.geom, 0).sum(axis=(3, 4))
        recip = (F32(1.0) / layer.geom.len_plane().astype(F32)).astype(F32)
        mean = (recip[None, :, :, None] * s.astype(F32)).astype(F32)
        return epilogue_pair(layer.c0, mean, layer.c1, lo, hi)
    return None


def teacher_forced(jgraph, tgraph, jparams, tparams, x0: np.ndarray,
                   backends=("xla", "pallas")) -> int:
    """Run every layer of both packages on the JAX layer's input and hold
    the port, on each of its ``backends``, to the rule.  Each JAX layer is
    jitted, as the JAX package runs it, so XLA may contract its epilogue.
    Returns the total size of the FMA sets."""
    assert len(jgraph.layers) == len(tgraph.layers)
    x, sens = x0, 0
    for lj, lt in zip(jgraph.layers, tgraph.layers):
        run = jax.jit(lambda p, v, layer=lj: jbuilder.apply_layer(layer, p, v, "xla"))
        yj = np.asarray(run(jparams, jnp.asarray(x)))
        pair = expected_pair(lj, jparams, x)
        for backend in backends:
            yt = tbuilder.apply_layer(lt, tparams, torch.from_numpy(np.array(x)),
                                      backend).numpy()
            what = f"{jgraph.name} layer {lj.index} {type(lj).__name__} ({backend})"
            assert yt.shape == yj.shape and yt.dtype == yj.dtype, (what, yt.shape, yj.shape)
            if pair is not None:
                sens += assert_fma_rule(yt, yj, *pair, what=what)
            elif isinstance(lj, SoftmaxLayer):
                diff = np.abs(yt.astype(np.int64) - yj.astype(np.int64))
                assert diff.max(initial=0) <= 1, what
            else:
                assert np.array_equal(yt, yj), what
        x = yj
    return sens


def fma_sensitive(rng, count: int, c1=None):
    """``count`` (q, bias0, c1) triples on which ``bias0 + c1*f32(q)``
    rounds to another int8 value as one fused multiply-add than as a
    multiply then an add; ``c1`` may be fixed to one value."""
    qs, bs, cs = [], [], []
    while len(qs) < count:
        m = 2_000_000
        q = rng.integers(-(2**20), 2**20, m)
        c = (np.full(m, c1, F32) if c1 is not None
             else rng.uniform(1e-5, 2.5e-4, m).astype(F32))
        b = rng.uniform(-20.0, 20.0, m).astype(F32)
        sep, fma = epilogue_pair(c, q.astype(F32), b, -128, 127)
        hit = np.nonzero(sep != fma)[0]
        qs += q[hit].tolist()
        bs += b[hit].tolist()
        cs += c[hit].tolist()
    return (np.array(qs[:count], np.int64), np.array(bs[:count], F32),
            np.array(cs[:count], F32))
