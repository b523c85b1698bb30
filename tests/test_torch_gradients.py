"""The port's batched backward functions (``microflow_tpu_torch/train/
gradients.py``) against the JAX package's per-sample production functions
(run under ``jax.vmap``, as its trainer runs them) and its scatter oracles,
bit for bit, on layers of graphs written by ``microflow_tpu.models.synth``
and variants of them: stride 1 and 2, SAME and VALID padding, nonzero
per-channel weight zero points, RELU, RELU6 and NONE, a sample whose
gradient is all zero (0/0 -> NaN -> 0) and gradients whose i32 sums wrap.
Last, the bound under which the port's exact f32 sums (the conv norms, the
batch sum of the depthwise bias) equal the JAX package's f32 sums, on the
trained suffixes of the three bundled models."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microflow_tpu.core import activation as jact
from microflow_tpu.core import tensor as jtensor
from microflow_tpu.frontend import parse as jparse
from microflow_tpu.models import synth
from microflow_tpu.train import gradients as jgrad
from microflow_tpu_torch.compiler.ir import (
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    ReshapeLayer,
)
from microflow_tpu_torch.core import activation as tact
from microflow_tpu_torch.core import tensor as ttensor
from microflow_tpu_torch.core.numerics import broadcast_per_channel
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.models import person_detect_trainable, sine_trainable, speech_trainable
from microflow_tpu_torch.train import gradients as tgrad

B = 3


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    out = {}
    for name in ("lenet", "full_ops", "flat_conv"):
        path = synth.write(str(d / f"{name}.tflite"), getattr(synth, name)())
        out[name] = (jparse(path, frontend="python"), tparse(path))
    return out


def _geometry(mod, g, stride, padding):
    pad = getattr(mod.ViewPadding, padding)
    if padding == "SAME":
        oh, ow = math.ceil(g.in_rows / stride), math.ceil(g.in_cols / stride)
    else:
        oh = math.ceil((g.in_rows - g.k_rows + 1) / stride)
        ow = math.ceil((g.in_cols - g.k_cols + 1) / stride)
    return mod.ViewGeometry(g.in_rows, g.in_cols, g.k_rows, g.k_cols, oh, ow, stride, stride,
                            pad)


def variant(pair, stride, padding, act, wzp):
    """The (JAX, port) layer pair with another stride, padding, activation
    and, where ``wzp``, per-channel weight zero points."""
    out = []
    for layer, tens, acts in ((pair[0], jtensor, jact), (pair[1], ttensor, tact)):
        geom = _geometry(tens, layer.geom, stride, padding)
        kw = {"geom": geom, "activation": getattr(acts.FusedActivation, act)}
        if wzp is not None:
            kw["w_q"] = dataclasses.replace(layer.w_q, zero_point=np.asarray(wzp, np.int64))
        out.append(dataclasses.replace(layer, **kw))
    return out


def layer_pair(graphs, model, cls):
    jg, tg = graphs[model]
    (i,) = [k for k, layer in enumerate(tg.layers) if isinstance(layer, cls)][:1]
    return jg.layers[i], tg.layers[i]


def d_out_draw(rng, shape, kind):
    """i32 gradients: ``small`` within the int8 grid's differences,
    ``wrap`` multiples of 2**29 whose i32 contractions wrap (their f32 sums
    stay exact).  Sample 1 is all zero either way."""
    if kind == "small":
        d = rng.integers(-255, 256, shape).astype(np.int32)
    else:
        d = (rng.integers(-2, 3, shape) * 2**29).astype(np.int32)
    d[1] = 0
    return d


def same(port, ref, what):
    port, ref = port.cpu().numpy(), np.asarray(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape, (what, port.dtype, ref.dtype)
    assert port.tobytes() == ref.tobytes(), (what, np.argwhere(port != ref)[:5])


def jax_batched(fn, layer, x, out, w, d, w_zp):
    """The JAX package's per-sample function over the batch, as its
    trainer runs it."""
    return jax.vmap(lambda xi, yi, gi: fn(layer, xi, yi, jnp.asarray(w), gi, w_zp))(
        jnp.asarray(x), jnp.asarray(out), jnp.asarray(d))


CONV_CASES = [
    # model, stride, padding, activation, per-channel wzp
    ("lenet", 1, "SAME", "RELU", False),
    ("lenet", 2, "SAME", "RELU6", True),
    ("lenet", 2, "VALID", "NONE", False),
    ("lenet", 1, "VALID", "RELU6", True),
    ("full_ops", 1, "SAME", "NONE", True),
    ("full_ops", 2, "VALID", "RELU", False),
]


@pytest.mark.parametrize("kind", ["small", "wrap"])
@pytest.mark.parametrize("model,stride,padding,act,wzp", CONV_CASES)
def test_conv_backward_matches_jax_and_scatter_oracle(graphs, model, stride, padding, act,
                                                      wzp, kind):
    rng = np.random.default_rng(stride * 7 + len(model))
    jl, tl = layer_pair(graphs, model, Conv2DLayer)
    F_, KH, KW, C = tl.filters.shape
    zps = rng.integers(-5, 6, F_) if wzp else None
    jl, tl = variant((jl, tl), stride, padding, act, zps)
    g = tl.geom
    x = rng.integers(-128, 128, (B, g.in_rows, g.in_cols, C), dtype=np.int8)
    out = rng.integers(-128, 128, (B, g.out_rows, g.out_cols, F_), dtype=np.int8)
    d = d_out_draw(rng, (B, g.out_rows, g.out_cols, F_), kind)
    w = tl.filters.copy()
    w_zp = broadcast_per_channel(tl.w_q.zero_point, F_, np.int32)
    port = tgrad.conv_backward_sample(tl, torch.from_numpy(x), torch.from_numpy(out),
                                      torch.from_numpy(w), torch.from_numpy(d), w_zp)
    oracle = tgrad.conv_backward_sample_scatter(tl, torch.from_numpy(x), torch.from_numpy(out),
                                                torch.from_numpy(w), torch.from_numpy(d), w_zp)
    jax_prod = jax_batched(jgrad.conv_backward_sample, jl, x, out, w, d, w_zp)
    jax_oracle = jax_batched(jgrad.conv_backward_sample_scatter, jl, x, out, w, d, w_zp)
    for name, p, o, jp, jo in zip(("dW", "bias", "dIn"), port, oracle, jax_prod, jax_oracle):
        same(p, jp, name)
        same(o, jo, name)
    assert port[0].count_nonzero() > 0 and port[2].count_nonzero() > 0
    assert not port[0][1].any() and not port[2][1].any()  # the zero sample: 0/0 -> 0


DW_CASES = [
    ("full_ops", 2, "SAME", "RELU6", False),
    ("full_ops", 1, "VALID", "NONE", True),
    ("flat_conv", 1, "SAME", "RELU", True),
    ("flat_conv", 2, "VALID", "RELU6", False),
]


@pytest.mark.parametrize("kind", ["small", "wrap"])
@pytest.mark.parametrize("model,stride,padding,act,wzp", DW_CASES)
def test_dwconv_backward_matches_jax_and_scatter_oracle(graphs, model, stride, padding, act,
                                                        wzp, kind):
    rng = np.random.default_rng(stride * 5 + len(model))
    jl, tl = layer_pair(graphs, model, DepthwiseConv2DLayer)
    KH, KW, CH = tl.weights.shape
    zps = rng.integers(-5, 6, CH) if wzp else None
    jl, tl = variant((jl, tl), stride, padding, act, zps)
    g = tl.geom
    x = rng.integers(-128, 128, (B, g.in_rows, g.in_cols, CH), dtype=np.int8)
    out = rng.integers(-128, 128, (B, g.out_rows, g.out_cols, CH), dtype=np.int8)
    d = d_out_draw(rng, (B, g.out_rows, g.out_cols, CH), kind)
    w = tl.weights.copy()
    w_zp = broadcast_per_channel(tl.w_q.zero_point, CH, np.int32)
    args = [torch.from_numpy(a) for a in (x, out, w, d)]
    port = tgrad.dwconv_backward_sample(tl, *args, w_zp)
    oracle = tgrad.dwconv_backward_sample_scatter(tl, *args, w_zp)
    jax_prod = jax_batched(jgrad.dwconv_backward_sample, jl, x, out, w, d, w_zp)
    jax_oracle = jax_batched(jgrad.dwconv_backward_sample_scatter, jl, x, out, w, d, w_zp)
    for name, p, o, jp, jo in zip(("dW", "bias", "dIn"), port, oracle, jax_prod, jax_oracle):
        same(p, jp, name)
        same(o, jo, name)
    assert port[1].count_nonzero() > 0
    if kind == "small":  # the wrap draw's one norm a sample rounds every ratio to 0
        assert port[0].count_nonzero() > 0 and port[2].count_nonzero() > 0


def test_dwconv_depth_multiplier_raises(graphs):
    jl, tl = layer_pair(graphs, "full_ops", DepthwiseConv2DLayer)
    g, ch = tl.geom, tl.weights.shape[2]
    x = torch.zeros((1, g.in_rows, g.in_cols, ch + 1), dtype=torch.int8)
    y = torch.zeros((1, g.out_rows, g.out_cols, ch), dtype=torch.int8)
    for fn in (tgrad.dwconv_backward_sample, tgrad.dwconv_backward_sample_scatter):
        with pytest.raises(NotImplementedError, match="depth multiplier"):
            fn(tl, x, y, torch.from_numpy(tl.weights.copy()), y.to(torch.int32),
               np.zeros(ch, np.int32))


@pytest.mark.parametrize("model", ["lenet", "full_ops"])
def test_avgpool_backward_matches_jax(graphs, model):
    rng = np.random.default_rng(3)
    jl, tl = layer_pair(graphs, model, AveragePool2DLayer)
    g = tl.geom
    c = tl.out_shape[-1]
    out = rng.integers(-128, 128, (B, g.out_rows, g.out_cols, c), dtype=np.int8)
    for kind in ("small", "wrap"):
        d = d_out_draw(rng, (B, g.out_rows, g.out_cols, c), kind)
        want = jax.vmap(lambda yi, gi: jgrad.avgpool_backward_sample(jl, yi, gi))(
            jnp.asarray(out), jnp.asarray(d))
        same(tgrad.avgpool_backward_sample(tl, torch.from_numpy(out), torch.from_numpy(d)),
             want, kind)


@pytest.mark.parametrize("act", ["NONE", "RELU", "RELU6"])
@pytest.mark.parametrize("kind", ["small", "wrap"])
def test_fc_backward_matches_jax(graphs, act, kind):
    """FC gradients: the i32 dot over the batch and the input gradient's
    dot wrap as XLA's; the input gradient masks on the raw output."""
    rng = np.random.default_rng(len(act))
    jl, tl = layer_pair(graphs, "lenet", FullyConnectedLayer)
    jl = dataclasses.replace(jl, activation=getattr(jact.FusedActivation, act))
    tl = dataclasses.replace(tl, activation=getattr(tact.FusedActivation, act))
    K, N = tl.weights.shape
    for batch in (1, 7):
        x = rng.integers(-128, 128, (batch, K), dtype=np.int8)
        out = rng.integers(-128, 128, (batch, N), dtype=np.int8)
        d = d_out_draw(rng, (batch + 1, N), kind)[:batch][::-1].copy()
        port = tgrad.fc_backward(tl, *(torch.from_numpy(a) for a in (x, out, tl.weights, d)))
        want = jgrad.fc_backward(jl, *(jnp.asarray(a) for a in (x, out, tl.weights, d)))
        for name, p, j in zip(("dW", "bias", "dIn"), port, want):
            same(p, j, name)


def test_fc_backward_float_within_tolerance(graphs):
    """The f32 twins: two f32 matmuls, which XLA and torch sum in other
    orders; held to 1e-6 of the largest entry of each result."""
    rng = np.random.default_rng(9)
    jl, tl = layer_pair(graphs, "lenet", FullyConnectedLayer)
    K, N = tl.weights.shape
    x = rng.integers(-128, 128, (7, K), dtype=np.int8)
    out = rng.integers(-128, 128, (7, N), dtype=np.int8)
    d = rng.normal(0, 0.3, (7, N)).astype(np.float32)
    port = tgrad.fc_backward_float(tl, *(torch.from_numpy(a) for a in (x, out, tl.weights, d)))
    want = jgrad.fc_backward_float(jl, *(jnp.asarray(a) for a in (x, out, tl.weights, d)))
    for p, j in zip(port, want):
        j = np.asarray(j)
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=1e-6 * np.abs(j).max())


def test_int_dot_chunks_past_the_exact_length():
    """A contraction longer than ``DOT_CHUNK`` (an FC weight gradient over
    a large batch) is cut into exact float64 chunks: equal to int64."""
    rng = np.random.default_rng(0)
    k = 3 * tgrad.DOT_CHUNK + 5
    a = rng.integers(-255, 256, (2, k)).astype(np.int32)
    b = rng.integers(-2**31, 2**31, (k, 3)).astype(np.int64)
    b[:, 0] = -(2**31)
    got = tgrad.int_dot(torch.from_numpy(a), torch.from_numpy(b.astype(np.int32)))
    assert got.dtype == torch.int64
    want = [[sum(int(p) * int(q) for p, q in zip(a[i], b[:, j])) for j in range(3)]
            for i in range(2)]
    assert got.tolist() == want


# --- trouble spot 2: where the exact f32 sums equal the JAX package's --------


def d_out_bounds(model) -> dict:
    """Per backward layer, a bound on |d_out| walked from the loss: loss
    gradients are differences of int8-grid values (<= 255); a conv or
    depthwise input gradient is a weighted average of centred weights
    (<= max|w - w_zp|, NaN -> 0); a pool adds each gradient once per
    covering window; a reshape passes it through; an FC input gradient is
    an unnormalized dot."""
    graph = model.graph
    bound, out = 255, {}
    for i in reversed(model.backward_indices):
        layer = graph.layers[i]
        out[i] = bound
        if isinstance(layer, (Conv2DLayer, DepthwiseConv2DLayer)):
            w = layer.filters if isinstance(layer, Conv2DLayer) else layer.weights
            ch = w.shape[0] if isinstance(layer, Conv2DLayer) else w.shape[-1]
            zp = broadcast_per_channel(layer.w_q.zero_point, ch, np.int64)
            zp = zp[:, None, None, None] if isinstance(layer, Conv2DLayer) else zp
            bound = int(np.abs(w.astype(np.int64) - zp).max())
        elif isinstance(layer, AveragePool2DLayer):
            cover = layer.geom.valid_mask_plane().sum(axis=(0, 1)).max()  # windows a tap
            bound *= int(max(cover, 1))
        elif isinstance(layer, FullyConnectedLayer):
            bound *= 255 * layer.weights.shape[1]
        else:
            assert isinstance(layer, ReshapeLayer), type(layer)
    return out


MODELS = {"sine": sine_trainable, "speech": speech_trainable,
          "person_detect": person_detect_trainable}
BATCH_MAX = 1024  # the largest batch chip_smoke.py's train phase runs


@pytest.mark.parametrize("name", list(MODELS))
def test_f32_sums_of_the_trained_suffixes_stay_exact(name, monkeypatch):
    """Every f32 sum of integers the backward takes (the conv norms
    ``norm_b``/``norm_w``, the depthwise ``norm``, the batch sum of the
    depthwise bias) stays below 2**24 on the three models' trained
    suffixes up to batch ``BATCH_MAX``, so any order of f32 adds gives the
    port's exact result.  Statically, from ``d_out_bounds``; and in a run,
    that the gradients each layer meets are within those bounds."""
    model = MODELS[name](device="cpu")
    bounds = d_out_bounds(model)
    graph = model.graph
    for i, bound in bounds.items():
        layer = graph.layers[i]
        if isinstance(layer, (Conv2DLayer, DepthwiseConv2DLayer)):
            oh, ow, ch = layer.out_shape
            assert bound * oh * ow * ch < 2**24, (name, i, bound)  # a sample's norm
            if isinstance(layer, DepthwiseConv2DLayer):
                assert bound * oh * ow * BATCH_MAX < 2**24, (name, i)  # the batch's bias sum
    seen = {}
    for fn in ("conv_backward_sample", "dwconv_backward_sample", "avgpool_backward_sample",
               "fc_weight_sums"):
        orig = getattr(tgrad, fn)

        def spy(layer, *args, _orig=orig):
            d_out = args[-2] if len(args) == 5 else args[-1]
            seen[layer.index] = max(seen.get(layer.index, 0), int(d_out.abs().max()))
            return _orig(layer, *args)

        monkeypatch.setattr(tgrad, fn, spy)
    g = torch.Generator().manual_seed(1)
    xq = torch.randint(-128, 128, (16, *graph.input_shape), generator=g, dtype=torch.int8)
    gt = torch.randint(-128, 128, (16, *graph.output_shape), generator=g, dtype=torch.int8)
    model.predict_quantized_train(xq, gt)
    assert seen and all(seen[i] <= bounds[i] for i in seen), (seen, bounds)
