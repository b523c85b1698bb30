"""The port's export (``microflow_tpu_torch/frontend/{writer,export}.py``,
``CompiledModel.export``) against the JAX package's: given the same graph,
the same params as numpy and the same description, both write the same
bytes, for the bundled models, every synthetic model and two param sets
the port trained.  An exported model reparsed by the port computes the same
bits; a trained one stays within 1 LSB of the trained model (the bias is
quantized on export); the 2**23 bias guard raises in both."""

import os

import numpy as np
import pytest
import torch

from microflow_tpu.frontend import parse as jparse
from microflow_tpu.frontend.export import export_tflite as jexport
from microflow_tpu.models import synth as jsynth
from microflow_tpu_torch import compile_tflite
from microflow_tpu_torch import models as tmodels
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.frontend import export as texport_mod
from microflow_tpu_torch.frontend.export import export_tflite as texport
from microflow_tpu_torch.models import model_path

BUNDLED = ("sine", "speech", "person_detect")
SYNTH = ("lenet", "full_ops", "flat_conv", "uint8_mlp", "per_channel_dw")
DESC = "microflow_tpu export: parity"


def np_params(model) -> dict:
    return {k: {kk: v.cpu().numpy() for kk, v in d.items()} for k, d in model.params.items()}


def same_bytes(path: str, params=None) -> bytes:
    got = texport(tparse(path), params, DESC)
    want = jexport(jparse(path, frontend="python"), params, DESC)
    assert got == want
    return got


@pytest.mark.parametrize("name", BUNDLED)
def test_bundled_export_bytes_equal_jax(name):
    same_bytes(model_path(name))


@pytest.mark.parametrize("gen", SYNTH)
def test_synth_export_bytes_equal_jax(gen, tmp_path):
    path = jsynth.write(str(tmp_path / f"{gen}.tflite"), getattr(jsynth, gen)())
    same_bytes(path)


def train_two_steps(name: str):
    """A port trainer after two steps and updates, and its inputs."""
    rng = np.random.default_rng(4)
    if name == "sine":
        m = tmodels.sine_trainable(device="cpu")
        x = rng.uniform(0, 2 * np.pi, (16, 1)).astype(np.float32)
        gt = m.quantize_target(x / 4)
        lr = 0.05
    else:
        m = tmodels.person_detect_trainable(10, device="cpu")
        x = rng.uniform(0, 1, (8, 96, 96, 1)).astype(np.float32)
        gt = torch.full((8, 2), -128, dtype=torch.int8)
        gt[torch.arange(8), torch.as_tensor(rng.integers(0, 2, 8))] = 127
        lr = 0.5
    before = m.predict_inner(m.quantize_input(x))
    for _ in range(2):
        m.predict_train(x, gt, lr)
        m.update_layers(len(x), lr)
    after = m.predict_inner(m.quantize_input(x))
    assert not torch.equal(after, before), "training moved no output"
    return m, x


@pytest.mark.parametrize("name", ["sine", "person_detect"])
def test_trained_params_export_bytes_equal_jax(name):
    m, _ = train_two_steps(name)
    data = same_bytes(model_path(name), np_params(m))
    assert data != texport(tparse(model_path(name)), None, DESC)  # the trained params went in


@pytest.mark.parametrize("name", BUNDLED)
def test_export_reparsed_computes_the_same_bits(name, tmp_path):
    m = compile_tflite(model_path(name), name=name, backend="xla", device="cpu")
    path = str(tmp_path / f"{name}.tflite")
    data = m.export(path)
    with open(path, "rb") as f:
        assert f.read() == data
    assert data.find(f"microflow_tpu_torch export: {name}".encode()) > 0
    m2 = compile_tflite(path, name=f"{name}_rt", backend="xla", device="cpu")
    xq = np.random.default_rng(3).integers(-128, 128, (8, *m.graph.input_shape), dtype=np.int8)
    assert torch.equal(m.predict_inner(xq), m2.predict_inner(xq))


def test_trained_sine_export_within_one_lsb(tmp_path):
    m, x = train_two_steps("sine")
    path = str(tmp_path / "sine_trained.tflite")
    m.export(path)
    m2 = compile_tflite(path, name="sine_trained", backend="xla", device="cpu")
    xq = m.quantize_input(x)
    diff = (m2.predict_inner(xq).to(torch.int32) - m.predict_inner(xq).to(torch.int32)).abs()
    print(f"{int((diff > 0).sum())} of {diff.numel()} outputs differ")
    assert int(diff.max()) <= 1


@pytest.mark.parametrize("package", ["port", "jax"])
def test_bias_guard_raises(package):
    """A folded bias whose |bias - bias_zp| reaches 2**23 cannot round-trip
    through f32 exactly: both exports refuse it."""
    from microflow_tpu.frontend import export as jexport_mod

    mod = texport_mod if package == "port" else jexport_mod
    graph = (tparse if package == "port" else jparse)(model_path("sine"))
    layer = graph.layers[0]
    per_lsb = float(layer.bias_q.scale0) / float(layer.out_q.scale0)
    c0 = np.full(layer.c0.shape, 1.5 * 2.0**23 * per_lsb, np.float32)
    with pytest.raises(ValueError, match="2\\*\\*23"):
        mod.export_tflite(graph, {"layer0": {"c0": c0}})
    mod.export_tflite(graph, {"layer0": {"c0": c0 / np.float32(3)}})  # 2**22: no error
