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

The whole-network kernels (flat, colfc) round with the TPU kernels'
``exact2`` (``trunc(y + (y >= 0 ? 0.5 : -0.5))``) instead of round-half-away;
``epilogue_pair(..., rounding="exact2")`` gives their pair, and against the
XLA oracle the ``exact2`` corner ``exact2_corner`` (y = +-(0.5 - 2**-25))
is allowed besides the FMA set.  The flat kernel's ``fixed`` epilogue
(``f32(q) * m`` then ``+-0.5``, then a truncation) has an FMA set of its
own: ``fixed_pair`` and ``fixed_chain_sets``.
"""

from __future__ import annotations

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import torch

from microflow_tpu.compiler import builder as jbuilder
from microflow_tpu.compiler import ir as jir
from microflow_tpu.core import activation as jactivation
from microflow_tpu.core import tensor as jtensor
from microflow_tpu.compiler.ir import (
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    SoftmaxLayer,
)
from microflow_tpu.core.activation import FusedActivation, quantize_scalar
from microflow_tpu_torch.compiler import builder as tbuilder
from microflow_tpu_torch.core.numerics import broadcast_per_channel as _per_channel
from microflow_tpu_torch.core.numerics import np_epilogue as epilogue_values
from microflow_tpu_torch.core.numerics import np_exact2 as exact2
from microflow_tpu_torch.core.numerics import np_round_away as round_away

F32 = np.float32


def bounds(activation, out_scale, out_zp, dtype) -> tuple[int, int]:
    info = np.iinfo(dtype)
    lo, hi = info.min, info.max
    if activation in (FusedActivation.RELU, FusedActivation.RELU6):
        lo = max(lo, int(out_zp))
    if activation is FusedActivation.RELU6:
        hi = min(hi, quantize_scalar(6.0, out_scale, out_zp, dtype))
    return lo, hi


def epilogue_pair(a, b, add, lo, hi, rounding: str = "round_away"):
    """Integer outputs of ``clip(round(add + a*b))`` computed as a multiply
    then an add (the reference) and as one fused multiply-add; ``round`` is
    round-half-away or, with ``rounding="exact2"``, ``exact2``."""
    rnd = exact2 if rounding == "exact2" else round_away
    sep, fma = epilogue_values(a, b, add)
    return (np.clip(rnd(sep), lo, hi).astype(np.int64),
            np.clip(rnd(fma), lo, hi).astype(np.int64))


def exact2_corner(a, b, add, lo, hi) -> np.ndarray:
    """Where ``exact2`` and round-half-away give other integers for the
    multiply-then-add value: y = +-(0.5 - 2**-25)."""
    sep, _ = epilogue_values(a, b, add)
    return np.clip(exact2(sep), lo, hi) != np.clip(round_away(sep), lo, hi)


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


def accumulator(layer, params: dict, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The exact int64 accumulator ``q`` of a FullyConnected, Conv2D or
    DepthwiseConv2D layer on input ``x`` (channels last) and its per-channel
    ``c1`` (f32)."""
    p = {k: np.asarray(v) for k, v in params[f"layer{layer.index}"].items()}
    in_zp = layer.in_q.zp0
    if isinstance(layer, FullyConnectedLayer):
        x2 = x.reshape(x.shape[0], -1).astype(np.int64)
        w = p["weights"].astype(np.int64)
        q = (x2 @ w - x2.sum(1, keepdims=True) * layer.w_q.zp0
             - p["c2"].astype(np.int64)[None, :] + layer.c3)
        return q, np.full(q.shape[1], layer.c1, F32)
    if isinstance(layer, Conv2DLayer):
        nf = layer.filters.shape[0]
        wzp = _per_channel(layer.w_q.zero_point, nf, np.int64)
        wc = p["weights"].astype(np.int64) - wzp[:, None, None, None]
        pt = _patches(x, layer.geom, in_zp) - in_zp
        return np.einsum("bijmnc,fmnc->bijf", pt, wc), _per_channel(layer.c1, nf, F32)
    ch = layer.weights.shape[2]
    in_c = x.shape[-1]
    xs = x[..., [c if c < in_c else 0 for c in range(ch)]]
    wzp = _per_channel(layer.w_q.zero_point, ch, np.int64)
    wc = p["weights"].astype(np.int64) - wzp[None, None, :]
    pt = _patches(xs, layer.geom, in_zp) - in_zp
    return np.einsum("bijmnc,mnc->bijc", pt, wc), _per_channel(layer.c1, ch, F32)


def epilogue_terms(layer, params: dict, x: np.ndarray):
    """``(c1, f32(q), bias0, lo, hi, conv)`` of a requantizing layer on input
    ``x``, from its exact accumulator; ``conv`` is False for the pool (whose
    epilogue is ``c1 + c0*mean``, round-half-away in every backend).  None
    for layers without that epilogue."""
    dtype = np.dtype(x.dtype)
    if isinstance(layer, (FullyConnectedLayer, Conv2DLayer, DepthwiseConv2DLayer)):
        lo, hi = bounds(layer.activation, layer.out_q.scale0, layer.out_q.zp0, dtype)
        bias0 = F32(layer.out_q.zp0) + np.asarray(params[f"layer{layer.index}"]["c0"]).astype(F32)
        q, c1 = accumulator(layer, params, x)
        return c1, q.astype(F32), bias0, lo, hi, True
    if isinstance(layer, AveragePool2DLayer):
        lo, hi = bounds(layer.activation, layer.out_q.scale0, layer.out_q.zp0, dtype)
        s = _patches(x, layer.geom, 0).sum(axis=(3, 4))
        recip = (F32(1.0) / layer.geom.len_plane().astype(F32)).astype(F32)
        mean = (recip[None, :, :, None] * s.astype(F32)).astype(F32)
        return layer.c0, mean, layer.c1, lo, hi, False
    return None


def expected_pair(layer, params: dict, x: np.ndarray, rounding: str = "round_away"):
    """(multiply-then-add, fused) integer outputs of a requantizing layer,
    from its exact accumulator; None for layers without that epilogue.
    ``rounding="exact2"`` rounds the conv/FC epilogues as the whole-network
    kernels do (the pool keeps round-half-away)."""
    terms = epilogue_terms(layer, params, x)
    if terms is None:
        return None
    *abl, conv = terms
    return epilogue_pair(*abl, rounding=rounding if conv else "round_away")


def chain_sets(jgraph, jparams, x0: np.ndarray, n_layers: int | None = None) -> dict:
    """Run the JAX XLA layer chain (each layer jitted, as the JAX package
    runs it) on ``x0`` and count, along it, the elements where an FMA
    rounds otherwise than a multiply then an add (under either rounding)
    and the ``exact2`` corners.  Returns the counts and the chain's
    outputs (``"outputs"``, one per layer)."""
    x, outs = x0, []
    counts = {"fma": 0, "fma_exact2": 0, "exact2_corner": 0}
    for lj in jgraph.layers[:n_layers]:
        terms = epilogue_terms(lj, jparams, x)
        if terms is not None:
            *abl, conv = terms
            sep, fma = epilogue_pair(*abl)
            counts["fma"] += int((sep != fma).sum())
            if conv:
                sep2, fma2 = epilogue_pair(*abl, rounding="exact2")
                counts["fma_exact2"] += int((sep2 != fma2).sum())
                counts["exact2_corner"] += int(exact2_corner(*abl).sum())
        run = jax.jit(lambda p, v, layer=lj: jbuilder.apply_layer(layer, p, v, "xla"))
        x = np.asarray(run(jparams, jnp.asarray(x)))
        outs.append(x)
    counts["outputs"] = outs
    return counts


def fixed_pair(q, bias_q, m, out_zp: int, lo: int, hi: int):
    """Integer outputs of the flat kernel's fixed-point epilogue on exact
    accumulators ``q`` (channels last) with per-channel ``bias_q`` and ``m``:
    ``q + bias_q`` wrapped to i32, ``p = f32(q) * m``, ``trunc(p + (p >= 0 ?
    0.5 : -0.5))``, then ``clip(t + out_zp, lo, hi)``; computed with the
    multiply and the add rounded apart (the kernels) and as one fused
    multiply-add (emulated in float64, where the product is exact)."""
    q32 = (np.asarray(q, np.int64) + np.asarray(bias_q, np.int64) + 2**31) % 2**32 - 2**31
    qf, m = q32.astype(F32), np.asarray(m, F32)
    p = (qf * m).astype(F32)
    h = np.where(p >= 0, F32(0.5), F32(-0.5))
    sep = np.trunc((p + h).astype(F32))
    fma = np.trunc((qf.astype(np.float64) * m.astype(np.float64) + h).astype(F32))
    return tuple(np.clip(t + F32(out_zp), lo, hi).astype(np.int64) for t in (sep, fma))


def fixed_chain_sets(jgraph, jparams, ops, x0: np.ndarray) -> dict:
    """Run the port's flat plan ``ops`` with ``requant="fixed"`` op by op
    (the plain version) on ``x0`` and count, along the chain, the elements
    where an FMA would round otherwise than a multiply then an add: in the
    fixed epilogue of the conv, dw and fc ops (from the JAX layer's exact
    accumulator and the plan's ``bias_q`` and ``m``) and in the pool's.
    Returns the counts and the chain's outputs (``"outputs"``)."""
    from microflow_tpu_torch.kernels.flatpack import flat_forward_reference

    x = x0.reshape(x0.shape[0], -1)
    counts, outs = {"fma_fixed": 0, "fma_pool": 0}, []
    for op in ops:
        layer = jgraph.layers[op.layer_idx]
        xs = x.reshape(x.shape[0], *op.in_shape)
        if op.kind in ("dw", "conv", "pw", "fc"):
            q, _ = accumulator(layer, jparams, xs)
            sep, fma = fixed_pair(q, op.bias_q, op.m, op.out_zp, op.clip_lo, op.clip_hi)
            counts["fma_fixed"] += int((sep != fma).sum())
        elif op.kind == "pool":
            sep, fma = expected_pair(layer, jparams, xs)
            counts["fma_pool"] += int((sep != fma).sum())
        x = flat_forward_reference([op], torch.from_numpy(x), "fixed").numpy()
        outs.append(x)
    counts["outputs"] = outs
    return counts


def trunc_sat(y) -> np.ndarray:
    """f32 values truncated toward zero and saturated to int8 (the flat
    kernel's ``noround`` cast, Mosaic's f32 -> int8 convert), as int64."""
    return np.trunc(np.clip(np.asarray(y, F32), -128, 127)).astype(np.int64)


def noround_chain(jgraph, jparams, ops, x0: np.ndarray, contract: bool):
    """Run the port's flat plan ``ops`` with ``requant="noround"`` op by op
    (the plain version) on ``x0``; with ``contract``, each conv, dw, pw and
    fc op's ``bias0 + c1*f32(q)`` is taken as one fused multiply-add
    (emulated in float64, from the JAX layer's exact accumulator), as XLA
    on the CPU runs the JAX interpret-mode kernel.  Returns the last op's
    output and the FMA set along this chain: ``(layer, flat indices)`` of
    every op where the fused and the separate truncations differ."""
    from microflow_tpu_torch.kernels.flatpack import flat_forward_reference

    b = x0.shape[0]
    x, hits = x0.reshape(b, -1), []
    for op in ops:
        y = flat_forward_reference([op], torch.from_numpy(x), "noround").numpy()
        if op.kind in ("dw", "conv", "pw", "fc"):
            layer = jgraph.layers[op.layer_idx]
            q, _ = accumulator(layer, jparams, x.reshape(b, *op.in_shape))
            sep, fma = (trunc_sat(v).reshape(b, -1)
                        for v in epilogue_values(op.c1, q.astype(F32), op.bias0))
            assert np.array_equal(sep, y), f"layer {op.layer_idx}: plain is not multiply-then-add"
            diff = np.flatnonzero(sep != fma)
            if diff.size:
                hits.append((op.layer_idx, diff.tolist()))
            if contract:
                y = fma.astype(np.int8)
        x = y
    return x, hits


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


_JAX_TYPES = {"QuantInfo": jir.QuantInfo, "ViewGeometry": jtensor.ViewGeometry,
              "ViewPadding": jtensor.ViewPadding, "FusedActivation": jactivation.FusedActivation}


def jax_graph(value):
    """The JAX package's counterpart of a graph (or any IR value) of the
    port: the same dataclass or enum by name, field for field, sharing the
    numpy arrays."""
    if isinstance(value, enum.Enum):
        return _JAX_TYPES[type(value).__name__](value.value)
    if dataclasses.is_dataclass(value):
        cls = _JAX_TYPES.get(type(value).__name__) or getattr(jir, type(value).__name__)
        fields = {f.name: getattr(value, f.name) for f in dataclasses.fields(value)}
        # the port's graph wiring: None on a chain, the only graph the JAX package has
        if type(value).__name__ == "Graph":
            assert fields.pop("wiring") is None, "the JAX package has no residual graph"
        return cls(**{name: jax_graph(v) for name, v in fields.items()})
    if isinstance(value, list):
        return [jax_graph(v) for v in value]
    return value
