#!/usr/bin/env python3
"""The device time of a person_detect_trainable(10) train step on one CUDA
card, split by part: the forward; each backward layer's parts (a 1x1
conv's weight gradient and fold, through plain torch and through
``qwgrad``, and its mask and input gradient; a depthwise layer's backward
and fold); the whole backward on either path; the update; and a whole
step as the trainer replays it.

    python3 scripts/torch_train_split.py [--batch 1024] [--iters 10]

Each part is captured ``--iters`` times in one CUDA graph and replayed
between two CUDA events (``chip_smoke.graph_ms``), so the host's cost is
not in it.  A step is the trainer's own: ``predict_quantized_train`` then
``update_layers``, replayed, CUDA events around ``--iters`` of them.
Prints one JSON line with the card's name and power limit.  Needs CUDA;
fails without it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from microflow_tpu_torch.compiler.ir import Conv2DLayer, DepthwiseConv2DLayer  # noqa: E402
from microflow_tpu_torch.kernels import qwgrad  # noqa: E402
from microflow_tpu_torch.models import person_detect_trainable  # noqa: E402
from microflow_tpu_torch.train import gradients, optimizer  # noqa: E402

LR = 0.01


def layer_inputs(m, params, acts, gt) -> dict:
    """Each conv and depthwise layer's backward arguments in one plain
    backward: index -> (layer, x_q, out_q, weights, d_out, w_zp)."""
    seen = {}
    names = ("conv_backward_sample", "dwconv_backward_sample")
    orig = {n: getattr(gradients, n) for n in names}

    def spy(n):
        def call(layer, *args):
            seen[layer.index] = (layer, *args)
            return orig[n](layer, *args)
        return call

    takes = qwgrad.takes_kernel
    try:
        for n in names:
            setattr(gradients, n, spy(n))
        qwgrad.takes_kernel = lambda *a: False
        m._run(m._backward_phase, params, acts, gt, m.grads, 0, [gt.shape[0]])
    finally:
        for n in names:
            setattr(gradients, n, orig[n])
        qwgrad.takes_kernel = takes
    return seen


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_split: CUDA is not available", file=sys.stderr)
        return 1
    dev, n, B = torch.device("cuda"), args.iters, args.batch
    m = person_detect_trainable(10, backend="pallas", device=dev)
    xq, gt = chip_smoke.train_batch(m, B, torch.Generator().manual_seed(16))
    params, grads = m.params, m.grads
    acts, _ = m._run(m._forward_phase, params, xq, [B])
    parts = {"forward": chip_smoke.graph_ms(lambda: m._run(m._forward_phase, params, xq, [B]), n)}
    layers = {}
    for i, (layer, x, out_q, w, d_out, wzp) in sorted(layer_inputs(m, params, acts, gt).items()):
        acc = grads[f"layer{i}"]["weights_gradient"]
        if isinstance(layer, Conv2DLayer):
            md = gradients.mask_d_out(layer, out_q, d_out)
            row = {
                "mask_ms": chip_smoke.graph_ms(
                    lambda: gradients.mask_d_out(layer, out_q, d_out), n),
                "input_grad_ms": chip_smoke.graph_ms(
                    lambda: gradients.conv_input_grad(layer, md, w, wzp), n),
                "wgrad_fold_plain_ms": chip_smoke.graph_ms(
                    lambda: optimizer.accumulate_gradient_4d_fold(
                        gradients.conv_weight_grad_sample(layer, x, md), acc, 0), n),
                "wgrad_fold_qwgrad_ms": chip_smoke.graph_ms(
                    lambda: qwgrad.qwgrad(layer, x, md, acc), n),
                "whole_plain_ms": chip_smoke.graph_ms(lambda: optimizer.accumulate_gradient_4d_fold(
                    gradients.conv_backward_sample(layer, x, out_q, w, d_out, wzp)[0], acc, 0), n)}
        elif isinstance(layer, DepthwiseConv2DLayer):
            row = {"backward_and_fold_ms": chip_smoke.graph_ms(
                lambda: optimizer.accumulate_gradient_4d_fold(
                    gradients.dwconv_backward_sample(layer, x, out_q, w, d_out, wzp)[0], acc, 0),
                n)}
        else:
            continue
        layers[f"layer{i}"] = {"kind": type(layer).__name__, **row}
    parts["backward"] = chip_smoke.graph_ms(
        lambda: m._run(m._backward_phase, params, acts, gt, grads, 0, [B]), n)
    takes = qwgrad.takes_kernel
    qwgrad.takes_kernel = lambda *a: False
    try:
        parts["backward_plain"] = chip_smoke.graph_ms(
            lambda: m._run(m._backward_phase, params, acts, gt, grads, 0, [B]), n)
    finally:
        qwgrad.takes_kernel = takes
    parts["update"] = chip_smoke.graph_ms(lambda: m._run(m._update_phase, params, grads, B, LR),
                                          n)

    def step():
        m.predict_quantized_train(xq, gt, LR)
        m.update_layers(B, LR)

    parts["step_replayed"] = chip_smoke.time_ms(step, n, warmup=3)
    convs = [v for v in layers.values() if v["kind"] == "Conv2DLayer"]
    sums = {
        "wgrad_fold_plain_ms": sum(v["wgrad_fold_plain_ms"] for v in convs),
        "wgrad_fold_qwgrad_ms": sum(v["wgrad_fold_qwgrad_ms"] for v in convs),
        "conv_mask_and_input_grad_ms": sum(v["mask_ms"] + v["input_grad_ms"] for v in convs),
        "depthwise_backward_and_fold_ms": sum(v["backward_and_fold_ms"] for v in layers.values()
                                              if v["kind"] == "DepthwiseConv2DLayer")}
    print(json.dumps({"batch": B, "iters": n, "device": chip_smoke.nvidia_smi("name,power.limit"),
                      "parts_ms": parts, "sums": sums, "layers": layers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
