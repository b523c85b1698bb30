"""MobileNetV2 1.0 at 224x224x3 as an int8 ``.tflite``, with seeded random
weights, and how far its output depends on its input.

The network is Table 2 of Sandler et al., "MobileNetV2: Inverted Residuals
and Linear Bottlenecks" (arXiv:1801.04381) at width 1.0, with the head of
TF-slim's ``mobilenet_v2`` (TFLite's ``mobilenet_v2_1.0_224_quant``): a
1x1 conv to 1001 classes, reshape, softmax.  Convolutions carry a bias and
no batch norm, as in a converted model; ReLU6 is fused; projections are
linear; ``padding="same"`` throughout; the pool is ``AveragePooling2D(7)``
(``GlobalAveragePooling2D`` would be written as ``MEAN``).  TensorFlow's
converter quantizes it (``TFLITE_BUILTINS_INT8``, int8 input and output,
per-channel weights) from a seeded representative set of uniform [-1, 1]
inputs.

Random weights easily give a softmax that no input moves, whose int8
outputs all sit on the output zero point, and a check of such outputs sees
no fault.  Keras' default initializers do that here: the depthwise
kernels' variance is divided by their channels, and the signal of the
input is gone by the fifth block.  So every conv followed by a ReLU6 takes
He's variance (2 / fan-in; 2 / 9 for a depthwise 3x3), every linear one
LeCun's (1 / fan-in), and biases a normal of ``BIAS_STD``.  The output then
depends on the input: in the benchmark's plain reference at least 90% of
the rows of a seeded batch of 1024 must give distinct output rows, and at
least 1% of the output elements must lie off the output zero point
(``figures``).

    python3 scripts/make_mobilenet_v2.py write [--seed 25] [--out PATH]   # needs TensorFlow
    python3 scripts/make_mobilenet_v2.py figures [--device cuda] [--rows 1024] [--seed N]

``write`` prints the float network's figures on the representative set;
``figures`` runs the benchmark's plain reference (``benchmark/
reference_residual``, plain torch) on ``--rows`` rows drawn as the
benchmark draws a pool batch from ``--seed`` and prints the two figures
as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "benchmark", "configs", "mobilenet_v2.tflite")
SEED = 25
BIAS_STD = 0.01
REPRESENTATIVE = 64
# Table 2: (expansion t, output channels c, repeats n, first stride s)
BOTTLENECKS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
               (6, 160, 3, 2), (6, 320, 1, 1))
CLASSES = 1001


def keras_model(seed: int):
    """The float network, batch 1, weights drawn from ``seed``."""
    import tensorflow as tf
    from tensorflow import keras
    from tensorflow.keras import layers

    tf.keras.utils.set_random_seed(seed)
    relu6 = lambda: layers.ReLU(6.0)  # noqa: E731
    bias = lambda: keras.initializers.RandomNormal(stddev=BIAS_STD)  # noqa: E731

    def conv(x, c, k=1, s=1, act=True):
        # He's variance before a ReLU6, LeCun's before a linear projection,
        # so that the signal neither dies nor saturates over 52 layers
        init = "he_normal" if act else "lecun_normal"
        x = layers.Conv2D(c, k, strides=s, padding="same", kernel_initializer=init,
                          bias_initializer=bias())(x)
        return relu6()(x) if act else x

    x = inp = keras.Input((224, 224, 3), batch_size=1)
    x = conv(x, 32, 3, 2)
    c_in = 32
    for t, c, n, s in BOTTLENECKS:
        for i in range(n):
            stride = s if i == 0 else 1
            y = conv(x, c_in * t) if t != 1 else x
            y = layers.DepthwiseConv2D(3, strides=stride, padding="same",
                                       # He's variance over the 9 taps (Keras'
                                       # "he_normal" counts 9 x channels)
                                       depthwise_initializer=keras.initializers.RandomNormal(
                                           stddev=(2.0 / 9.0) ** 0.5),
                                       bias_initializer=bias())(y)
            y = relu6()(y)
            y = conv(y, c, act=False)
            x = layers.Add()([x, y]) if stride == 1 and c_in == c else y
            c_in = c
    x = conv(x, 1280)
    x = layers.AveragePooling2D(7)(x)
    x = layers.Conv2D(CLASSES, 1, padding="same", kernel_initializer="lecun_normal",
                      bias_initializer=bias())(x)
    x = layers.Reshape((CLASSES,))(x)
    out = layers.Softmax()(x)
    return keras.Model(inp, out)


def representative(seed: int, n: int = REPRESENTATIVE) -> np.ndarray:
    rng = np.random.default_rng([seed, 1])
    return rng.uniform(-1.0, 1.0, (n, 1, 224, 224, 3)).astype(np.float32)


def dependence(rows: np.ndarray, zero_point: int) -> dict:
    """The share of rows that no other row equals, and of elements off the
    output zero point, in %."""
    _, counts = np.unique(rows.reshape(len(rows), -1), axis=0, return_counts=True)
    distinct = float((counts == 1).sum()) / len(rows)
    return {"rows": int(len(rows)), "distinct_rows_pct": 100.0 * distinct,
            "off_zero_point_pct": 100.0 * float((rows != zero_point).mean())}


def write(seed: int, out: str) -> None:
    import tensorflow as tf

    model = keras_model(seed)
    data = representative(seed)
    probs = np.concatenate([model(x, training=False).numpy() for x in data])
    # the float softmax on the int8 output grid (scale 1/256, zero point -128)
    grid = np.clip(np.round(probs * 256.0) - 128, -128, 127).astype(np.int8)
    print("float network on the representative set:", json.dumps(dependence(grid, -128)))

    def gen():
        for x in data:
            yield [x]

    conv = tf.lite.TFLiteConverter.from_keras_model(model)
    conv.optimizations = [tf.lite.Optimize.DEFAULT]
    conv.representative_dataset = gen
    conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
    conv.inference_input_type = tf.int8
    conv.inference_output_type = tf.int8
    blob = conv.convert()
    with open(out, "wb") as f:
        f.write(blob)
    print(f"wrote {out}: {len(blob)} bytes")


def figures(path: str, device: str, rows: int, seed: int) -> dict:
    import torch

    sys.path.insert(0, ROOT)
    from benchmark.reference_residual.model import Reference
    from benchmark.traffic import int8_rows, torch_generator

    dev = torch.device(device)
    ref = Reference(path, dev)
    xq = int8_rows(torch_generator(seed, dev), (rows, *ref.graph.input_shape), dev)
    y = ref.forward(xq).cpu().numpy()
    return {"seed": seed, **dependence(y, ref.graph.output_q.zp0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("write", "figures"))
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=1024)
    args = ap.parse_args()
    if args.what == "write":
        write(args.seed, args.out)
    else:
        print(json.dumps(figures(args.out, args.device, args.rows, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
