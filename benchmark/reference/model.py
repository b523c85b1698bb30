"""The benchmark's plain reference: a quantized ``.tflite`` model's forward
pass and its integer training step, in plain torch, from the frozen copies
of the parser, the fold, the ops and the trainer's layer functions beside
this file.  It imports nothing of the program under test; it reads the
model file itself and works out every constant again.

``Reference(path)`` parses and folds the model; ``forward(xq)`` is the
int pipeline (``predict_inner``'s semantics); ``quantize``/``dequantize``
are the model's input and output conversions.  ``Trainer`` is the
quantized-gradient training step (forward, loss gradient, backward, the
batch-order saturating fold) and the update, as the MicroFlow train
codegen defines them.

``int4=True`` is the benchmark's control: every weight snapped to the
16 levels of int4 (``round(w / 16) * 16``, clamped), the step below the
int8 the configuration states, FC's C2 folded again from the snapped
weights.  It has to fail every cell's comparison.
"""

from __future__ import annotations

import numpy as np
import torch

from .compiler.ir import (
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    QuantizeLayer,
    ReshapeLayer,
    SoftmaxLayer,
)
from .core.numerics import broadcast_per_channel, f32, torch_dtype
from .core.quantize import dequantize, quantize
from .core.tensor import reshape_2d
from .frontend.parser import parse
from .ops import (
    average_pool_2d,
    conv_2d,
    depthwise_conv_2d,
    fully_connected,
    quantize_op,
    reshape,
    softmax,
)
from .train import gradients, losses, optimizer


def to_int4_grid(weights: np.ndarray) -> np.ndarray:
    """int8 weights on the int4 grid: ``round(w / 16)`` in [-8, 7], times 16."""
    q = np.clip(np.round(weights.astype(np.float64) / 16.0), -8, 7)
    return (q * 16).clip(-128, 127).astype(weights.dtype)


def init_params(graph, device, snap_int4: bool = False) -> dict:
    """``{"layerN": {"weights", "c0", "c2"?}}`` as tensors on ``device``."""
    params = {}
    for layer in graph.layers:
        if isinstance(layer, FullyConnectedLayer):
            w = to_int4_grid(layer.weights) if snap_int4 else layer.weights
            c2 = (w.astype(np.int64).sum(axis=0) * layer.in_q.zp0).astype(np.int32)
            params[f"layer{layer.index}"] = {"weights": w, "c0": layer.c0, "c2": c2}
        elif isinstance(layer, Conv2DLayer):
            w = to_int4_grid(layer.filters) if snap_int4 else layer.filters
            params[f"layer{layer.index}"] = {"weights": w, "c0": layer.c0}
        elif isinstance(layer, DepthwiseConv2DLayer):
            w = to_int4_grid(layer.weights) if snap_int4 else layer.weights
            params[f"layer{layer.index}"] = {"weights": w, "c0": layer.c0}
    return {k: {n: torch.as_tensor(np.array(v), device=device) for n, v in arrs.items()}
            for k, arrs in params.items()}


def _bias0(layer, p: dict) -> torch.Tensor:
    return f32(p["c0"]) + float(layer.out_q.zp0)


def apply_layer(layer, params: dict, x: torch.Tensor) -> torch.Tensor:
    """One IR layer through the plain ops."""
    if isinstance(layer, FullyConnectedLayer):
        if layer.flatten_input:
            x = reshape_2d(x)
        p = params[f"layer{layer.index}"]
        return fully_connected(
            x, p["weights"], w_zp=layer.w_q.zp0, bias0=_bias0(layer, p), c1=layer.c1,
            c2=p["c2"], c3=layer.c3, out_scale=layer.out_q.scale0, out_zp=layer.out_q.zp0,
            activation=layer.activation)
    if isinstance(layer, Conv2DLayer):
        p = params[f"layer{layer.index}"]
        num_f = layer.filters.shape[0]
        return conv_2d(
            x, p["weights"], geom=layer.geom, in_zp=layer.in_q.zp0,
            w_zp=broadcast_per_channel(layer.w_q.zero_point, num_f, np.int32),
            bias0=_bias0(layer, p), c1=broadcast_per_channel(layer.c1, num_f, np.float32),
            out_scale=layer.out_q.scale0, out_zp=layer.out_q.zp0,
            activation=layer.activation)
    if isinstance(layer, DepthwiseConv2DLayer):
        p = params[f"layer{layer.index}"]
        ch = layer.weights.shape[2]
        return depthwise_conv_2d(
            x, p["weights"], geom=layer.geom, in_zp=layer.in_q.zp0,
            w_zp=broadcast_per_channel(layer.w_q.zero_point, ch, np.int32),
            bias0=_bias0(layer, p), c1=broadcast_per_channel(layer.c1, ch, np.float32),
            out_scale=layer.out_q.scale0, out_zp=layer.out_q.zp0,
            activation=layer.activation)
    if isinstance(layer, AveragePool2DLayer):
        return average_pool_2d(
            x, geom=layer.geom, c0=layer.c0, c1=layer.c1, out_scale=layer.out_q.scale0,
            out_zp=layer.out_q.zp0, activation=layer.activation)
    if isinstance(layer, SoftmaxLayer):
        if x.dim() > 2:
            x = reshape_2d(x)
        return softmax(x, in_scale=layer.in_q.scale0, out_scale=layer.out_q.scale0,
                       out_zp=layer.out_q.zp0)
    if isinstance(layer, ReshapeLayer):
        return reshape(x, layer.out_shape)
    if isinstance(layer, QuantizeLayer):
        return quantize_op(
            x, in_scale=layer.in_q.scale0, in_zp=layer.in_q.zp0,
            out_scale=layer.out_q.scale0, out_zp=layer.out_q.zp0,
            out_dtype=torch_dtype(layer.out_dtype))
    raise TypeError(f"unknown layer {type(layer)}")


class Reference:
    """A parsed, folded model and its plain forward on ``device``."""

    def __init__(self, path: str, device, int4: bool = False):
        self.graph = parse(path)
        self.device = torch.device(device)
        self.params = init_params(self.graph, self.device, snap_int4=int4)

    @property
    def input_dtype(self) -> torch.dtype:
        return torch_dtype(self.graph.input_dtype)

    def quantize(self, x) -> torch.Tensor:
        g = self.graph
        x = torch.as_tensor(x, device=self.device).to(torch.float32)
        return quantize(x, g.input_q.scale0, g.input_q.zp0, dtype=self.input_dtype)

    def dequantize(self, yq: torch.Tensor) -> torch.Tensor:
        g = self.graph
        return dequantize(yq, g.output_q.scale0, g.output_q.zp0)

    @torch.no_grad()
    def forward(self, xq: torch.Tensor, block: int = 1024) -> torch.Tensor:
        """int [B, *input_shape] -> int [B, *output_shape], ``block`` rows
        at a time so that it fits beside the program's leftovers."""
        outs = []
        for start in range(0, xq.shape[0], block):
            x = xq[start:start + block].to(self.device)
            for layer in self.graph.layers:
                x = apply_layer(layer, self.params, x)
            outs.append(x)
        return torch.cat(outs)


class Trainer(Reference):
    """The quantized-gradient trainer of the last ``num_train_layers``
    operators (``skip_last`` leaves the final one, the softmax, out of the
    backward and puts the loss before it)."""

    def __init__(self, path: str, device, num_train_layers: int, loss: str, skip_last: bool,
                 int4: bool = False):
        super().__init__(path, device, int4=int4)
        n = len(self.graph.layers)
        train = [layer.index for layer in self.graph.layers[n - num_train_layers:]]
        self.backward = train[:-1] if skip_last else train
        self.loss, self.loss_index = loss, self.backward[-1]
        self.layers = [self.graph.layers[i] for i in self.backward]
        self.wzp = {}
        for layer in self.layers:
            if isinstance(layer, (Conv2DLayer, DepthwiseConv2DLayer)):
                n_out = (layer.filters.shape[0] if isinstance(layer, Conv2DLayer)
                         else layer.weights.shape[2])
                self.wzp[layer.index] = torch.as_tensor(
                    broadcast_per_channel(layer.w_q.zero_point, n_out, np.int32),
                    device=self.device)
        self.grads = self._zero_grads()

    def _zero_grads(self) -> dict:
        grads = {}
        for layer in self.layers:
            key = f"layer{layer.index}"
            if key in self.params:
                grads[key] = {
                    "weights_gradient": torch.zeros(self.params[key]["weights"].shape,
                                                    dtype=torch.int32, device=self.device),
                    "c0_gradient": torch.zeros(self.params[key]["c0"].shape,
                                               dtype=torch.float32, device=self.device)}
        return grads

    @torch.no_grad()
    def step(self, xq: torch.Tensor, gt_q: torch.Tensor) -> torch.Tensor:
        """Forward and backward of one batch; accumulates ``grads``.
        Returns the dequantized output of the loss layer."""
        graph, params = self.graph, self.params
        xq, gt_q = xq.to(self.device), gt_q.to(self.device)
        acts, keep, x = {}, set(self.backward), xq
        for layer in graph.layers:
            y = apply_layer(layer, params, x)
            if layer.index in keep:
                acts[layer.index] = (x, y)
            x = y
        loss_layer = graph.layers[self.loss_index]
        loss_out = acts[self.loss_index][1]
        if self.loss == "mse":
            g = losses.mse_grad(loss_out, gt_q)
        else:
            g = losses.crossentropy_grad(loss_out, graph.output_q.scale0, graph.output_q.zp0,
                                         gt_q, in_scale=loss_layer.out_q.scale0)
        for layer in reversed(self.layers):
            key = f"layer{layer.index}"
            lg = self.grads.get(key)
            x_in, y_out = acts[layer.index]
            if isinstance(layer, FullyConnectedLayer):
                x2 = reshape_2d(x_in) if layer.flatten_input else x_in
                dW, bias_grad, g = gradients.fc_backward(layer, x2, y_out,
                                                         params[key]["weights"], g)
                lg["weights_gradient"] = optimizer.accumulate_gradient_2d(
                    dW, lg["weights_gradient"])
                lg["c0_gradient"] = lg["c0_gradient"] + bias_grad
                if layer.flatten_input:
                    g = g.reshape(x_in.shape)
            elif isinstance(layer, Conv2DLayer):
                dW_b, _, g = gradients.conv_backward_sample(
                    layer, x_in, y_out, params[key]["weights"], g, self.wzp[layer.index])
                lg["weights_gradient"] = optimizer.accumulate_gradient_4d_fold(
                    dW_b, lg["weights_gradient"])
            elif isinstance(layer, DepthwiseConv2DLayer):
                dW_b, bias_b, g = gradients.dwconv_backward_sample(
                    layer, x_in, y_out, params[key]["weights"], g, self.wzp[layer.index])
                lg["weights_gradient"] = optimizer.accumulate_gradient_4d_fold(
                    dW_b, lg["weights_gradient"])
                lg["c0_gradient"] = lg["c0_gradient"] + gradients.exact_f32_sum(bias_b, 0)
            elif isinstance(layer, AveragePool2DLayer):
                g = gradients.avgpool_backward_sample(layer, y_out, g)
            elif isinstance(layer, ReshapeLayer):
                g = g.reshape(x_in.shape)
        return dequantize(loss_out, loss_layer.out_q.scale0, loss_layer.out_q.zp0)

    @torch.no_grad()
    def update(self, batch_size: int, lr: float) -> None:
        """Clip-norm SGD on FC weights, rounded SGD on conv weights, the f32
        step on C0, C2 folded again; the gradients zeroed."""
        for layer in self.layers:
            key = f"layer{layer.index}"
            if key not in self.grads:
                continue
            p, g = dict(self.params[key]), self.grads[key]
            if isinstance(layer, FullyConnectedLayer):
                p["weights"] = optimizer.update_weights_clip_norm_2d(
                    p["weights"], g["weights_gradient"], batch_size, lr)
                p["c2"] = optimizer.update_constants_fully_connected(p["weights"],
                                                                     layer.in_q.zp0)
            else:
                p["weights"] = optimizer.update_weights_4d(
                    p["weights"], g["weights_gradient"], batch_size, lr)
            p["c0"] = optimizer.update_weights_2d_float(p["c0"], g["c0_gradient"],
                                                        batch_size, lr)
            self.params[key] = p
        self.grads = self._zero_grads()
