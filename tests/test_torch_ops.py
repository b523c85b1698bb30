"""The torch port's plain ops (``microflow_tpu_torch.ops``) against the JAX
package's ops on random inputs, in the pattern of ``tests/test_ops.py``,
under the FMA rule of ``torch_parity.py``; plus the reference's own
hand-computed unit-test constants."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity as tp

from microflow_tpu import ops as jops
from microflow_tpu.core import FusedActivation as JAct
from microflow_tpu.core import ViewGeometry as JGeom
from microflow_tpu.core import ViewPadding as JPad
from microflow_tpu.ops.quantize_op import quantize_op as j_quantize_op
from microflow_tpu_torch import ops as tops
from microflow_tpu_torch.core import FusedActivation as TAct
from microflow_tpu_torch.core import ViewGeometry as TGeom
from microflow_tpu_torch.core import ViewPadding as TPad
from microflow_tpu_torch.core import reshape_2d, reshape_4d

F32 = np.float32
DT = {np.int8: torch.int8, np.uint8: torch.uint8}


def geoms(h, w, k, stride, padding):
    if padding == "same":
        oh, ow = -(-h // stride), -(-w // stride)
    else:
        oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
    kw = dict(in_rows=h, in_cols=w, k_rows=k, k_cols=k, out_rows=oh, out_cols=ow,
              stride_rows=stride, stride_cols=stride)
    return (JGeom(padding=JPad(padding), **kw), TGeom(padding=TPad(padding), **kw))


def ints(rng, shape, dt):
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max + 1, shape, dtype=dt)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def act_pair(name):
    return JAct(name), TAct(name)


@pytest.mark.parametrize("dt", [np.int8, np.uint8])
@pytest.mark.parametrize("act", ["none", "relu", "relu6"])
def test_fully_connected(dt, act):
    rng = np.random.default_rng(3)
    B, K, N = 7, 45, 13
    x, w = ints(rng, (B, K), dt), ints(rng, (K, N), dt)
    in_zp, w_zp, out_zp = (5, 128, 130) if dt == np.uint8 else (-7, 3, 4)
    c0 = rng.normal(0, 3, N).astype(F32)
    c1 = F32(0.0043)
    c2 = (w.astype(np.int64).sum(0) * in_zp).astype(np.int32)
    c3 = K * in_zp * w_zp
    bias0 = F32(out_zp) + c0
    ja, ta = act_pair(act)
    common = dict(w_zp=w_zp, c1=c1, c2=c2, c3=c3, out_scale=0.05, out_zp=out_zp)
    ref = np.asarray(jops.fully_connected(jnp.asarray(x), jnp.asarray(w), bias0=bias0,
                                          activation=ja, **common))
    got = tops.fully_connected(t(x), t(w), bias0=bias0, activation=ta, **common).numpy()
    q = (x.astype(np.int64) @ w.astype(np.int64) - x.astype(np.int64).sum(1, keepdims=True)
         * w_zp - c2.astype(np.int64) + c3)
    lo, hi = tp.bounds(ja, 0.05, out_zp, dt)
    tp.assert_fma_rule(got, ref, *tp.epilogue_pair(c1, q.astype(F32), bias0, lo, hi))
    assert got.dtype == dt


def _conv_case(rng, dt, B, H, W, C, F, k, stride, padding, per_channel):
    x = ints(rng, (B, H, W, C), dt)
    filt = ints(rng, (F, k, k, C), dt)
    in_zp = 120 if dt == np.uint8 else -2
    w_zp = (rng.integers(-9, 9, F) if per_channel else np.full(F, 3)).astype(np.int32)
    if dt == np.uint8:
        w_zp = w_zp + 128
    bias0 = (F32(-1) + rng.normal(0, 5, F)).astype(F32)
    c1 = rng.uniform(1e-4, 3e-3, F).astype(F32)
    return x, filt, in_zp, w_zp, bias0, c1


@pytest.mark.parametrize("dt,k,stride,padding,per_channel,H", [
    (np.int8, 3, 1, "same", True, 8),
    (np.int8, 3, 2, "same", True, 9),   # SAME stride 2 on odd sizes
    (np.int8, 1, 1, "same", False, 6),  # pointwise: im2col is a reshape
    (np.int8, 2, 2, "valid", True, 7),
    (np.uint8, 3, 2, "same", False, 7),
])
def test_conv_2d(dt, k, stride, padding, per_channel, H):
    rng = np.random.default_rng(11)
    x, filt, in_zp, w_zp, bias0, c1 = _conv_case(rng, dt, 2, H, H + 2, 5, 6, k, stride, padding,
                                                 per_channel)
    jg, tg = geoms(H, H + 2, k, stride, padding)
    out_zp = 10 if dt == np.uint8 else -1
    common = dict(in_zp=in_zp, w_zp=w_zp, bias0=bias0, c1=c1, out_scale=0.07, out_zp=out_zp)
    ref = np.asarray(jops.conv_2d(jnp.asarray(x), jnp.asarray(filt), geom=jg,
                                  activation=JAct.RELU, **common))
    got = tops.conv_2d(t(x), t(filt), geom=tg, activation=TAct.RELU, **common).numpy()
    pt = tp._patches(x, jg, in_zp) - in_zp
    q = np.einsum("bijmnc,fmnc->bijf", pt, filt.astype(np.int64) - w_zp[:, None, None, None])
    lo, hi = tp.bounds(JAct.RELU, 0.07, out_zp, dt)
    tp.assert_fma_rule(got, ref, *tp.epilogue_pair(c1, q.astype(F32), bias0, lo, hi))


@pytest.mark.parametrize("dt,in_c,stride,padding,H", [
    (np.int8, 4, 1, "same", 9),
    (np.int8, 4, 2, "same", 9),    # SAME stride 2 on odd sizes
    (np.int8, 1, 2, "same", 11),   # depth-multiplier stem: 1 -> 4 channels
    (np.int8, 2, 1, "valid", 8),   # channel fallback: channels >= 2 read channel 0
    (np.uint8, 4, 2, "same", 7),
])
def test_depthwise_conv_2d(dt, in_c, stride, padding, H):
    rng = np.random.default_rng(5)
    ch = 4
    x = ints(rng, (3, H, H, in_c), dt)
    wt = ints(rng, (3, 3, ch), dt)
    in_zp = 100 if dt == np.uint8 else -2
    w_zp = np.array([1, -3, 0, 5], np.int32) + (128 if dt == np.uint8 else 0)
    bias0 = (F32(-1) + rng.normal(0, 5, ch)).astype(F32)
    c1 = rng.uniform(0.001, 0.01, ch).astype(F32)
    jg, tg = geoms(H, H, 3, stride, padding)
    out_zp = 10 if dt == np.uint8 else -1
    common = dict(in_zp=in_zp, w_zp=w_zp, bias0=bias0, c1=c1, out_scale=0.07, out_zp=out_zp)
    ref = np.asarray(jops.depthwise_conv_2d(jnp.asarray(x), jnp.asarray(wt), geom=jg,
                                            activation=JAct.RELU6, **common))
    got = tops.depthwise_conv_2d(t(x), t(wt), geom=tg, activation=TAct.RELU6, **common).numpy()
    xs = x[..., [c if c < in_c else 0 for c in range(ch)]]
    pt = tp._patches(xs, jg, in_zp) - in_zp
    q = np.einsum("bijmnc,mnc->bijc", pt, wt.astype(np.int64) - w_zp[None, None, :])
    lo, hi = tp.bounds(JAct.RELU6, 0.07, out_zp, dt)
    tp.assert_fma_rule(got, ref, *tp.epilogue_pair(c1, q.astype(F32), bias0, lo, hi))


@pytest.mark.parametrize("k,stride,padding,H", [(2, 2, "valid", 8), (3, 2, "same", 7),
                                                (3, 1, "same", 5), (3, 2, "valid", 6)])
def test_average_pool_2d(k, stride, padding, H):
    rng = np.random.default_rng(9)
    x = ints(rng, (3, H, H, 6), np.int8)
    jg, tg = geoms(H, H, k, stride, padding)
    c0, c1 = F32(0.8666667), F32(3.8666666)
    common = dict(c0=c0, c1=c1, out_scale=0.15, out_zp=16)
    ref = np.asarray(jops.average_pool_2d(jnp.asarray(x), geom=jg, activation=JAct.NONE,
                                          **common))
    got = tops.average_pool_2d(t(x), geom=tg, activation=TAct.NONE, **common).numpy()
    s = tp._patches(x, jg, 0).sum(axis=(3, 4))
    recip = (F32(1) / jg.len_plane().astype(F32)).astype(F32)
    mean = (recip[None, :, :, None] * s.astype(F32)).astype(F32)
    tp.assert_fma_rule(got, ref, *tp.epilogue_pair(c0, mean, c1, -128, 127))


def test_softmax_within_one_lsb():
    rng = np.random.default_rng(2)
    x = ints(rng, (64, 10), np.int8)
    kw = dict(in_scale=0.05, out_scale=1 / 256, out_zp=-128)
    ref = np.asarray(jops.softmax(jnp.asarray(x), **kw)).astype(np.int64)
    got = tops.softmax(t(x), **kw).numpy().astype(np.int64)
    assert np.abs(got - ref).max() <= 1


@pytest.mark.parametrize("in_dt,out_dt", [(np.int8, np.int8), (np.int8, np.uint8),
                                          (np.uint8, np.int8)])
def test_quantize_op(in_dt, out_dt):
    rng = np.random.default_rng(4)
    x = ints(rng, (5, 40), in_dt)
    kw = dict(in_scale=0.02, in_zp=-3 if in_dt == np.int8 else 128, out_scale=0.015, out_zp=5)
    ref = np.asarray(j_quantize_op(jnp.asarray(x), out_dtype=out_dt, **kw))
    got = tops.quantize_op(t(x), out_dtype=DT[out_dt], **kw).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_reshape_roundtrip():
    x = torch.arange(24, dtype=torch.int8).reshape(2, 2, 3, 2)
    x2 = tops.reshape(x, (12,))
    assert x2.shape == (2, 12) and torch.equal(tops.reshape(x2, (2, 3, 2)), x)
    assert torch.equal(reshape_2d(x), x2) and torch.equal(reshape_4d(x2, 2, 3, 2), x)


# --- the reference's hand-computed unit tests (src/ops/*.rs), as in test_ops.py


def _nhwc(vals):
    return torch.tensor([vals], dtype=torch.int8)


REF_X = [[[1, 2], [3, 4], [5, 6]], [[7, 8], [9, 10], [11, 12]]]
REF_GEOM = TGeom(in_rows=2, in_cols=3, k_rows=2, k_cols=3, out_rows=2, out_cols=3,
                 stride_rows=1, stride_cols=1, padding=TPad.SAME)


def test_reference_fully_connected():
    out = tops.fully_connected(
        torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int8),
        torch.tensor([[9, 10, 11, 12], [13, 14, 15, 16], [17, 18, 19, 20]], dtype=torch.int8),
        w_zp=22, bias0=F32(30) + np.array([-4.6551723, -3.724138, -2.7931035, -1.862069], F32),
        c1=F32(0.50689656), c2=np.array([312, 336, 360, 384], np.int32), c3=528,
        out_scale=0.29, out_zp=30, activation=TAct.RELU)
    assert out.tolist() == [[112, 103, 95, 87], [70, 67, 63, 60]]


def test_reference_conv_2d():
    filters = torch.tensor(
        [[[[15, 16], [17, 18], [19, 20]], [[21, 22], [23, 24], [25, 26]]],
         [[[27, 28], [29, 30], [31, 32]], [[33, 34], [35, 36], [37, 38]]]], dtype=torch.int8)
    out = tops.conv_2d(
        _nhwc(REF_X), filters, geom=REF_GEOM, in_zp=14, w_zp=np.array([41, 42], np.int32),
        bias0=F32(50) + np.array([-3.6734694, -3.755102], F32),
        c1=np.array([0.10346939, 0.10612245], F32), out_scale=0.49, out_zp=50,
        activation=TAct.NONE)
    assert out[0].tolist() == [[[127, 116], [127, 127], [127, 113]],
                               [[98, 74], [114, 84], [82, 67]]]


def test_reference_depthwise_conv_2d():
    weights = torch.tensor([[[15, 16], [17, 18], [19, 20]], [[21, 22], [23, 24], [25, 26]]],
                           dtype=torch.int8)
    out = tops.depthwise_conv_2d(
        _nhwc(REF_X), weights, geom=REF_GEOM, in_zp=14, w_zp=np.array([29, 30], np.int32),
        bias0=F32(38) + np.array([-3.5675676, -3.6756757], F32),
        c1=np.array([0.09486486, 0.09837838], F32), out_scale=0.37, out_zp=38,
        activation=TAct.NONE)
    assert out[0].tolist() == [[[66, 63], [82, 78], [65, 62]], [[47, 45], [52, 49], [44, 42]]]


def test_reference_average_pool_2d():
    out = tops.average_pool_2d(_nhwc(REF_X), geom=REF_GEOM, c0=0.8666667, c1=3.8666666,
                               out_scale=0.15, out_zp=16, activation=TAct.NONE)
    assert out[0].tolist() == [[[8, 9], [9, 10], [10, 11]], [[11, 12], [12, 13], [13, 13]]]


def test_reference_softmax():
    out = tops.softmax(torch.tensor([[1, 2, 3, 4, 5, 6]], dtype=torch.int8), in_scale=0.7,
                       out_scale=0.9, out_zp=10)
    assert out.reshape(2, 3).tolist() == [[10, 10, 10], [10, 10, 11]]


def test_fma_sensitive_epilogue_is_multiply_then_add():
    """Inputs chosen so that a fused multiply-add and the reference's
    multiply-then-add round differently: the port must give the latter on
    every one of them (and equal the JAX op everywhere else)."""
    rng = np.random.default_rng(21)
    c1 = F32(1.23e-4)
    q, b, _ = tp.fma_sensitive(rng, 16, c1)
    n = len(q)
    x = np.zeros((1, 3), np.int8)  # acc = rowsum = 0, so q = c3 - c2
    w = ints(rng, (3, n), np.int8)
    common = dict(w_zp=0, c1=c1, c2=(-q).astype(np.int32), c3=0, out_scale=1.0, out_zp=0)
    b0 = b.astype(F32)
    ref = np.asarray(jops.fully_connected(jnp.asarray(x), jnp.asarray(w), bias0=b0,
                                          activation=JAct.NONE, **common))
    got = tops.fully_connected(t(x), t(w), bias0=b0, activation=TAct.NONE, **common).numpy()
    sep, fma = tp.epilogue_pair(c1, q.astype(F32)[None, :], b0, -128, 127)
    assert tp.assert_fma_rule(got, ref, sep, fma) > 0
