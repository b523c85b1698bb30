"""Synthetic int8 model generators, built with the port's TFLite writer
(``frontend/writer.py``): the port's copy of ``microflow_tpu.models.synth``,
the same generators and seeds, so the same bytes.

These fill gaps the bundled reference models leave open:

* ``lenet()`` -- a LeNet-style CNN (conv/pool/conv/pool/fc/fc/softmax);
  the reference's ``examples/leNet_train.rs`` references a
  ``models/train/lenet.tflite`` that is NOT checked into its repo, so we
  fabricate an equivalent for the same train-configuration coverage.
* ``full_ops()`` -- one model exercising every supported builtin,
  including QUANTIZE (dead code in the reference, implemented here).
* ``flat_conv()``, ``uint8_mlp()``, ``per_channel_dw()`` -- a flat-packable
  conv stack, a uint8-era MLP and a per-channel depthwise conv.

Weights are deterministic (seeded).  Quantization parameters are
internally consistent (bias_scale = in_scale * w_scale, symmetric int8
weights), so the integer pipeline behaves like a real converter's output.
The descriptions the files carry are the JAX package's, so that the bytes
match.
"""

from __future__ import annotations

import numpy as np

from ..frontend.tflite import ActivationFunctionType as Act
from ..frontend.tflite import BuiltinOperator as Op
from ..frontend.tflite import Padding, TensorType
from ..frontend.writer import ModelWriter

I8 = TensorType.INT8
I32 = TensorType.INT32


def _qweights(rng, shape, scale_hint=0.05):
    """Symmetric int8 quantized weights from a float draw."""
    w = rng.normal(0.0, scale_hint, shape).astype(np.float32)
    scale = np.float32(max(np.abs(w).max() / 127.0, 1e-6))
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, float(scale)


def _qbias(rng, n, in_scale, w_scale):
    b = rng.normal(0.0, 0.1, n).astype(np.float32)
    s = np.float32(in_scale * w_scale)
    return np.clip(np.round(b / s), -(2**31) + 1, 2**31 - 1).astype(np.int32), float(s)


def lenet(seed: int = 0) -> bytes:
    """LeNet-style int8 CNN: [B,12,12,1] -> 10 classes.

    conv3x3x8(relu, SAME) -> avgpool2x2/2 -> conv3x3x16(relu, SAME) ->
    avgpool2x2/2 -> reshape -> fc32(relu) -> fc10 -> softmax
    """
    rng = np.random.default_rng(seed)
    m = ModelWriter("microflow_tpu synthetic lenet")
    in_s, in_zp = 1 / 128.0, 0

    x0 = m.tensor([1, 12, 12, 1], I8, in_s, in_zp, name="input")

    w1, w1s = _qweights(rng, (8, 3, 3, 1), 0.4)
    b1, b1s = _qbias(rng, 8, in_s, w1s)
    a1_s, a1_zp = 1 / 64.0, -128
    t_w1 = m.tensor([8, 3, 3, 1], I8, w1s, 0, data=w1, name="conv1_w")
    t_b1 = m.tensor([8], I32, b1s, 0, data=b1, name="conv1_b")
    x1 = m.tensor([1, 12, 12, 8], I8, a1_s, a1_zp, name="conv1_out")
    m.add_op(Op.CONV_2D, [x0, t_w1, t_b1], [x1],
             m.conv_options(Padding.SAME, (1, 1), Act.RELU))

    x2 = m.tensor([1, 6, 6, 8], I8, a1_s, a1_zp, name="pool1_out")
    m.add_op(Op.AVERAGE_POOL_2D, [x1], [x2],
             m.pool_options(Padding.VALID, (2, 2), (2, 2), Act.NONE))

    w3, w3s = _qweights(rng, (16, 3, 3, 8), 0.2)
    b3, b3s = _qbias(rng, 16, a1_s, w3s)
    a3_s, a3_zp = 1 / 64.0, -128
    t_w3 = m.tensor([16, 3, 3, 8], I8, w3s, 0, data=w3, name="conv2_w")
    t_b3 = m.tensor([16], I32, b3s, 0, data=b3, name="conv2_b")
    x3 = m.tensor([1, 6, 6, 16], I8, a3_s, a3_zp, name="conv2_out")
    m.add_op(Op.CONV_2D, [x2, t_w3, t_b3], [x3],
             m.conv_options(Padding.SAME, (1, 1), Act.RELU))

    x4 = m.tensor([1, 3, 3, 16], I8, a3_s, a3_zp, name="pool2_out")
    m.add_op(Op.AVERAGE_POOL_2D, [x3], [x4],
             m.pool_options(Padding.VALID, (2, 2), (2, 2), Act.NONE))

    x5 = m.tensor([1, 144], I8, a3_s, a3_zp, name="flat")
    m.add_op(Op.RESHAPE, [x4], [x5], m.reshape_options([1, 144]))

    w6, w6s = _qweights(rng, (32, 144), 0.1)  # tflite FC layout [out, in]
    b6, b6s = _qbias(rng, 32, a3_s, w6s)
    a6_s, a6_zp = 1 / 32.0, -128
    t_w6 = m.tensor([32, 144], I8, w6s, 0, data=w6, name="fc1_w")
    t_b6 = m.tensor([32], I32, b6s, 0, data=b6, name="fc1_b")
    x6 = m.tensor([1, 32], I8, a6_s, a6_zp, name="fc1_out")
    m.add_op(Op.FULLY_CONNECTED, [x5, t_w6, t_b6], [x6], m.fc_options(Act.RELU))

    w7, w7s = _qweights(rng, (10, 32), 0.2)
    b7, b7s = _qbias(rng, 10, a6_s, w7s)
    a7_s, a7_zp = 1 / 16.0, 0
    t_w7 = m.tensor([10, 32], I8, w7s, 0, data=w7, name="fc2_w")
    t_b7 = m.tensor([10], I32, b7s, 0, data=b7, name="fc2_b")
    x7 = m.tensor([1, 10], I8, a7_s, a7_zp, name="logits")
    m.add_op(Op.FULLY_CONNECTED, [x6, t_w7, t_b7], [x7], m.fc_options(Act.NONE))

    x8 = m.tensor([1, 10], I8, 1 / 256.0, -128, name="probs")
    m.add_op(Op.SOFTMAX, [x7], [x8], m.softmax_options(1.0))

    return m.finish([x0], [x8])


def full_ops(seed: int = 1) -> bytes:
    """Every supported builtin in one graph, including QUANTIZE:
    [B,8,8,2] -> quantize(rescale) -> dwconv3x3(relu6, SAME, s2) ->
    conv1x1x4 -> avgpool(SAME 3x3 s2) -> reshape -> fc -> softmax."""
    rng = np.random.default_rng(seed)
    m = ModelWriter("microflow_tpu synthetic full-ops")

    x0 = m.tensor([1, 8, 8, 2], I8, 0.02, -3, name="input")
    x1 = m.tensor([1, 8, 8, 2], I8, 0.015, 5, name="requant")
    m.add_op(Op.QUANTIZE, [x0], [x1], None)

    wd, wds = _qweights(rng, (1, 3, 3, 2), 0.5)
    bd, bds = _qbias(rng, 2, 0.015, wds)
    t_wd = m.tensor([1, 3, 3, 2], I8, wds, 0, data=wd, name="dw_w")
    t_bd = m.tensor([2], I32, bds, 0, data=bd, name="dw_b")
    x2 = m.tensor([1, 4, 4, 2], I8, 0.02, -128, name="dw_out")
    m.add_op(Op.DEPTHWISE_CONV_2D, [x1, t_wd, t_bd], [x2],
             m.dwconv_options(Padding.SAME, (2, 2), 1, Act.RELU6))

    wc, wcs = _qweights(rng, (4, 1, 1, 2), 0.5)
    bc, bcs = _qbias(rng, 4, 0.02, wcs)
    t_wc = m.tensor([4, 1, 1, 2], I8, wcs, 0, data=wc, name="conv_w")
    t_bc = m.tensor([4], I32, bcs, 0, data=bc, name="conv_b")
    x3 = m.tensor([1, 4, 4, 4], I8, 0.03, 0, name="conv_out")
    m.add_op(Op.CONV_2D, [x2, t_wc, t_bc], [x3],
             m.conv_options(Padding.SAME, (1, 1), Act.NONE))

    x4 = m.tensor([1, 2, 2, 4], I8, 0.03, 0, name="pool_out")
    m.add_op(Op.AVERAGE_POOL_2D, [x3], [x4],
             m.pool_options(Padding.SAME, (2, 2), (3, 3), Act.NONE))

    x5 = m.tensor([1, 16], I8, 0.03, 0, name="flat")
    m.add_op(Op.RESHAPE, [x4], [x5], m.reshape_options([1, 16]))

    wf, wfs = _qweights(rng, (3, 16), 0.3)
    bf, bfs = _qbias(rng, 3, 0.03, wfs)
    t_wf = m.tensor([3, 16], I8, wfs, 0, data=wf, name="fc_w")
    t_bf = m.tensor([3], I32, bfs, 0, data=bf, name="fc_b")
    x6 = m.tensor([1, 3], I8, 0.05, 2, name="logits")
    m.add_op(Op.FULLY_CONNECTED, [x5, t_wf, t_bf], [x6], m.fc_options(Act.NONE))

    x7 = m.tensor([1, 3], I8, 1 / 256.0, -128, name="probs")
    m.add_op(Op.SOFTMAX, [x6], [x7], m.softmax_options(1.0))

    return m.finish([x0], [x7])


def flat_conv(seed: int = 5) -> bytes:
    """A conv stack whose every activation is flat-packable (H*W*C a
    multiple of 128) -- the kernels/flatpack.py planner test model:
    [B,16,16,2] -> dw3x3(relu) -> conv1x1x8(relu6, zp!=-128 so the f32
    clip is NOT elided) -> dw3x3 s2 PER-CHANNEL -> conv1x1x4 ->
    reshape -> fc -> softmax."""
    rng = np.random.default_rng(seed)
    m = ModelWriter("microflow_tpu synthetic flat-conv")
    x0 = m.tensor([1, 16, 16, 2], I8, 0.02, -1, name="input")

    wd, wds = _qweights(rng, (1, 3, 3, 2), 0.4)
    bd, bds = _qbias(rng, 2, 0.02, wds)
    t_wd = m.tensor([1, 3, 3, 2], I8, wds, 0, data=wd, name="dw1_w")
    t_bd = m.tensor([2], I32, bds, 0, data=bd, name="dw1_b")
    x1 = m.tensor([1, 16, 16, 2], I8, 0.018, -128, name="dw1_out")
    m.add_op(Op.DEPTHWISE_CONV_2D, [x0, t_wd, t_bd], [x1],
             m.dwconv_options(Padding.SAME, (1, 1), 1, Act.RELU))

    wc, wcs = _qweights(rng, (8, 1, 1, 2), 0.4)
    bc, bcs = _qbias(rng, 8, 0.018, wcs)
    t_wc = m.tensor([8, 1, 1, 2], I8, wcs, 0, data=wc, name="pw1_w")
    t_bc = m.tensor([8], I32, bcs, 0, data=bc, name="pw1_b")
    # zp = -100: quantize(6) < 127, so the relu6 clip stays in the kernel
    x2 = m.tensor([1, 16, 16, 8], I8, 0.03, -100, name="pw1_out")
    m.add_op(Op.CONV_2D, [x1, t_wc, t_bc], [x2],
             m.conv_options(Padding.SAME, (1, 1), Act.RELU6))

    w2 = rng.normal(0.0, 0.3, (1, 3, 3, 8)).astype(np.float32)
    s2 = np.maximum(np.abs(w2).max(axis=(0, 1, 2)) / 127.0, 1e-6).astype(np.float32)
    q2 = np.clip(np.round(w2 / s2[None, None, None, :]), -127, 127).astype(np.int8)
    b2 = np.round(rng.normal(0, 0.05, 8) / (0.03 * s2)).astype(np.int32)
    t_w2 = m.tensor([1, 3, 3, 8], I8, s2, np.zeros(8, np.int64), data=q2,
                    name="dw2_w", quantized_dimension=3)
    t_b2 = m.tensor([8], I32, (0.03 * s2).astype(np.float32),
                    np.zeros(8, np.int64), data=b2, name="dw2_b")
    x3 = m.tensor([1, 8, 8, 8], I8, 0.04, 3, name="dw2_out")
    m.add_op(Op.DEPTHWISE_CONV_2D, [x2, t_w2, t_b2], [x3],
             m.dwconv_options(Padding.SAME, (2, 2), 1, Act.NONE))

    wc2, wc2s = _qweights(rng, (4, 1, 1, 8), 0.4)
    bc2, bc2s = _qbias(rng, 4, 0.04, wc2s)
    t_wc2 = m.tensor([4, 1, 1, 8], I8, wc2s, 0, data=wc2, name="pw2_w")
    t_bc2 = m.tensor([4], I32, bc2s, 0, data=bc2, name="pw2_b")
    x4 = m.tensor([1, 8, 8, 4], I8, 0.05, 0, name="pw2_out")
    m.add_op(Op.CONV_2D, [x3, t_wc2, t_bc2], [x4],
             m.conv_options(Padding.SAME, (1, 1), Act.NONE))

    x5 = m.tensor([1, 256], I8, 0.05, 0, name="flat")
    m.add_op(Op.RESHAPE, [x4], [x5], m.reshape_options([1, 256]))

    wf, wfs = _qweights(rng, (3, 256), 0.2)
    bf, bfs = _qbias(rng, 3, 0.05, wfs)
    t_wf = m.tensor([3, 256], I8, wfs, 0, data=wf, name="fc_w")
    t_bf = m.tensor([3], I32, bfs, 0, data=bf, name="fc_b")
    x6 = m.tensor([1, 3], I8, 0.05, 2, name="logits")
    m.add_op(Op.FULLY_CONNECTED, [x5, t_wf, t_bf], [x6], m.fc_options(Act.NONE))

    x7 = m.tensor([1, 3], I8, 1 / 256.0, -128, name="probs")
    m.add_op(Op.SOFTMAX, [x6], [x7], m.softmax_options(1.0))

    return m.finish([x0], [x7])


def write(path: str, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return path


def uint8_mlp(seed: int = 2) -> bytes:
    """A uint8-era model: u8 activations and weights throughout
    (the reference's ``Quantized`` trait covers u8 alongside i8,
    ``src/quantize.rs:7-8``): [B,16] -> fc8(relu) -> fc4 -> softmax."""
    rng = np.random.default_rng(seed)
    U8 = TensorType.UINT8
    m = ModelWriter("microflow_tpu synthetic uint8 mlp")

    x0 = m.tensor([1, 16], U8, 1 / 64.0, 128, name="input")

    def uw(shape):
        w = rng.normal(0.0, 0.2, shape).astype(np.float32)
        scale = np.float32(max(np.abs(w).max() / 127.0, 1e-6))
        q = np.clip(np.round(w / scale) + 128, 0, 255).astype(np.uint8)
        return q, float(scale)

    w1, w1s = uw((8, 16))
    b1, b1s = _qbias(rng, 8, 1 / 64.0, w1s)
    t_w1 = m.tensor([8, 16], U8, w1s, 128, data=w1, name="fc1_w")
    t_b1 = m.tensor([8], I32, b1s, 0, data=b1, name="fc1_b")
    x1 = m.tensor([1, 8], U8, 1 / 32.0, 0, name="fc1_out")
    m.add_op(Op.FULLY_CONNECTED, [x0, t_w1, t_b1], [x1], m.fc_options(Act.RELU))

    w2, w2s = uw((4, 8))
    b2, b2s = _qbias(rng, 4, 1 / 32.0, w2s)
    t_w2 = m.tensor([4, 8], U8, w2s, 128, data=w2, name="fc2_w")
    t_b2 = m.tensor([4], I32, b2s, 0, data=b2, name="fc2_b")
    x2 = m.tensor([1, 4], U8, 1 / 16.0, 128, name="logits")
    m.add_op(Op.FULLY_CONNECTED, [x1, t_w2, t_b2], [x2], m.fc_options(Act.NONE))

    x3 = m.tensor([1, 4], U8, 1 / 256.0, 0, name="probs")
    m.add_op(Op.SOFTMAX, [x2], [x3], m.softmax_options(1.0))

    return m.finish([x0], [x3])


def per_channel_dw(seed: int = 4) -> bytes:
    """A dwconv with PER-CHANNEL weight quantization (quantized_dimension=3,
    the legacy layout person_detect uses that modern TFLite runtimes
    reject -- SURVEY §7 hard part (c)): [B,6,6,4] -> dw3x3(relu) -> fc ->
    softmax."""
    rng = np.random.default_rng(seed)
    m = ModelWriter("microflow_tpu synthetic per-channel dw")

    x0 = m.tensor([1, 6, 6, 4], I8, 0.02, -1, name="input")

    # per-channel symmetric weights: independent scale per channel
    w = rng.normal(0.0, 0.3, (1, 3, 3, 4)).astype(np.float32)
    scales = np.maximum(np.abs(w).max(axis=(0, 1, 2)) / 127.0, 1e-6).astype(np.float32)
    q = np.clip(np.round(w / scales[None, None, None, :]), -127, 127).astype(np.int8)
    b = np.round(rng.normal(0, 0.05, 4) / (0.02 * scales)).astype(np.int32)
    t_w = m.tensor([1, 3, 3, 4], I8, scales, np.zeros(4, np.int64), data=q,
                   name="dw_w", quantized_dimension=3)
    t_b = m.tensor([4], I32, (0.02 * scales).astype(np.float32),
                   np.zeros(4, np.int64), data=b, name="dw_b")
    x1 = m.tensor([1, 6, 6, 4], I8, 0.03, -128, name="dw_out")
    m.add_op(Op.DEPTHWISE_CONV_2D, [x0, t_w, t_b], [x1],
             m.dwconv_options(Padding.SAME, (1, 1), 1, Act.RELU))

    x2 = m.tensor([1, 144], I8, 0.03, -128, name="flat")
    m.add_op(Op.RESHAPE, [x1], [x2], m.reshape_options([1, 144]))

    wf, wfs = _qweights(rng, (3, 144), 0.2)
    bf, bfs = _qbias(rng, 3, 0.03, wfs)
    t_wf = m.tensor([3, 144], I8, wfs, 0, data=wf, name="fc_w")
    t_bf = m.tensor([3], I32, bfs, 0, data=bf, name="fc_b")
    x3 = m.tensor([1, 3], I8, 0.05, 0, name="logits")
    m.add_op(Op.FULLY_CONNECTED, [x2, t_wf, t_bf], [x3], m.fc_options(Act.NONE))

    x4 = m.tensor([1, 3], I8, 1 / 256.0, -128, name="probs")
    m.add_op(Op.SOFTMAX, [x3], [x4], m.softmax_options(1.0))

    return m.finish([x0], [x4])


def residual(seed: int = 6) -> bytes:
    """Inverted-residual blocks (MobileNetV2's, arXiv:1801.04381) joined by
    int8 ``ADD``s, at a small size, with per-channel weights as a converter
    writes them; the port's own generator (the JAX package has no ``ADD``):

    [B,16,16,3] -> conv3x3x8 s2 (relu6) -> dw3x3 (relu6) -> conv1x1x8 ->
    block A: 1x1x48 (relu6), dw3x3, 1x1x8, ADD with the block's input ->
    block B: 1x1x48 (relu6), dw3x3 s2 (relu6), 1x1x16, no ADD (the shape
    changes) -> block C: 1x1x96 (relu6), dw3x3 (relu6), 1x1x16, ADD (relu6)
    -> avgpool 4x4 -> conv1x1x10 -> reshape -> softmax.

    The first two layers are a plain chain, so a one-launch planner may
    take them; layer 2's output is read by block A twice."""
    rng = np.random.default_rng(seed)
    m = ModelWriter("microflow_tpu synthetic residual")
    six = (6.0 / 255.0, -128)  # a relu6 output's grid

    def weights(shape, axis, hint):
        w = rng.normal(0.0, hint, shape).astype(np.float32)
        other = tuple(a for a in range(len(shape)) if a != axis)
        s = np.maximum(np.abs(w).max(axis=other) / 127.0, 1e-6).astype(np.float32)
        bshape = [1] * len(shape)
        bshape[axis] = -1
        q = np.clip(np.round(w / s.reshape(bshape)), -127, 127).astype(np.int8)
        return q, s

    def layer(op, x, x_q, shape, out_shape, out_q, opts, hint, axis=0):
        q, s = weights(shape, axis, hint)
        n = shape[axis]
        bs = (np.float32(x_q[0]) * s).astype(np.float32)
        b = np.round(rng.normal(0.0, 0.05, n) / bs).astype(np.int32)
        t_w = m.tensor(list(shape), I8, s, np.zeros(n, np.int64), data=q, name="w",
                       quantized_dimension=axis)
        t_b = m.tensor([n], I32, bs, np.zeros(n, np.int64), data=b, name="b")
        y = m.tensor([1, *out_shape], I8, out_q[0], out_q[1], name="act")
        m.add_op(op, [x, t_w, t_b], [y], opts)
        return y

    def conv(x, x_q, c_in, hw, c_out, out_q, act, k=1, stride=1, hint=0.3):
        o = hw // stride
        return layer(Op.CONV_2D, x, x_q, (c_out, k, k, c_in), (o, o, c_out), out_q,
                     m.conv_options(Padding.SAME, (stride, stride), act), hint)

    def dw(x, x_q, c, hw, out_q, act, stride=1):
        o = hw // stride
        return layer(Op.DEPTHWISE_CONV_2D, x, x_q, (1, 3, 3, c), (o, o, c), out_q,
                     m.dwconv_options(Padding.SAME, (stride, stride), 1, act), 0.4, axis=3)

    def block(x, x_q, c_in, hw, c_out, stride, proj_q, add_q=None, add_act=Act.NONE):
        e = conv(x, x_q, c_in, hw, 6 * c_in, six, Act.RELU6)
        d = dw(e, six, 6 * c_in, hw, six, Act.RELU6, stride)
        p = conv(d, six, 6 * c_in, hw // stride, c_out, proj_q, Act.NONE)
        if add_q is None:
            return p, proj_q
        y = m.tensor([1, hw, hw, c_out], I8, add_q[0], add_q[1], name="add")
        m.add_op(Op.ADD, [x, p], [y], m.add_options(add_act))
        return y, add_q

    in_q = (1 / 128.0, 0)
    x0 = m.tensor([1, 16, 16, 3], I8, in_q[0], in_q[1], name="input")
    x = conv(x0, in_q, 3, 16, 8, six, Act.RELU6, k=3, stride=2)
    x = dw(x, six, 8, 8, six, Act.RELU6)
    x_q = (0.05, 3)
    x = conv(x, six, 8, 8, 8, x_q, Act.NONE)
    x, x_q = block(x, x_q, 8, 8, 8, 1, (0.04, -5), (0.07, 2))
    x, x_q = block(x, x_q, 8, 8, 16, 2, (0.06, 1))
    x, x_q = block(x, x_q, 16, 4, 16, 1, (0.05, -2), (6.0 / 255.0, -128), Act.RELU6)
    xp = m.tensor([1, 1, 1, 16], I8, x_q[0], x_q[1], name="pool")
    m.add_op(Op.AVERAGE_POOL_2D, [x], [xp],
             m.pool_options(Padding.VALID, (4, 4), (4, 4), Act.NONE))
    logits_q = (0.1, 4)
    xl = conv(xp, x_q, 16, 1, 10, logits_q, Act.NONE, hint=0.5)
    xr = m.tensor([1, 10], I8, logits_q[0], logits_q[1], name="flat")
    m.add_op(Op.RESHAPE, [xl], [xr], m.reshape_options([1, 10]))
    xs = m.tensor([1, 10], I8, 1 / 256.0, -128, name="probs")
    m.add_op(Op.SOFTMAX, [xr], [xs], m.softmax_options(1.0))
    return m.finish([x0], [xs])
