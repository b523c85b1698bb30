"""``params_from_numpy`` and the backend names of the torch port: both
packages given the same perturbed params (random int8 weight deltas, c0
and c2 offsets) still agree per layer, and the model computes from its
params rather than from the graph's constants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity as tp

from microflow_tpu.compiler.builder import apply_layer as j_apply_layer
from microflow_tpu.compiler.builder import init_params as j_init_params
from microflow_tpu.frontend import parse as jparse
from microflow_tpu.models import synth
from microflow_tpu_torch import compile_tflite, params_from_numpy
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.models import model_path
from test_torch_model import _input, _paths


def _perturb(params, rng):
    out = {}
    for layer, arrays in params.items():
        p = {k: np.asarray(v).copy() for k, v in arrays.items()}
        w = p["weights"]
        info = np.iinfo(w.dtype)
        delta = rng.integers(-3, 4, w.shape)
        p["weights"] = np.clip(w.astype(np.int64) + delta, info.min, info.max).astype(w.dtype)
        p["c0"] = (p["c0"] + rng.normal(0, 0.7, p["c0"].shape)).astype(np.float32)
        if "c2" in p:
            p["c2"] = (p["c2"] + rng.integers(-50, 50, p["c2"].shape)).astype(np.int32)
        out[layer] = p
    return out


@pytest.mark.parametrize("name", ["sine", "speech", "lenet", "full_ops"])
def test_params_from_numpy_perturbed(name, tmp_path):
    path = _paths(name, tmp_path)
    jg, tg = jparse(path, frontend="python"), tparse(path)
    rng = np.random.default_rng(3)
    params = _perturb(jax.tree_util.tree_map(np.asarray, j_init_params(jg)), rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = params_from_numpy(params, "cpu")
    assert all(isinstance(v, torch.Tensor) for p in tparams.values() for v in p.values())
    x0 = _input(jg, 16, rng)
    tp.teacher_forced(jg, tg, jparams, tparams, x0)
    # the model computes from its params, not from the graph's constants
    m = compile_tflite(path, backend="pallas", device="cpu")
    before = m.predict_inner(x0)
    m.params = tparams
    xj = jnp.asarray(x0)
    for layer in jg.layers:
        xj = j_apply_layer(layer, jparams, xj, "xla")
    after = m.predict_inner(x0).numpy().astype(np.int64)
    assert not np.array_equal(before.numpy(), after) or name == "sine"
    assert np.abs(after - np.asarray(xj).astype(np.int64)).max() <= 1


@pytest.mark.parametrize("name,backend", [("speech", "flat"), ("sine", "colfc"),
                                          ("person_detect", "packed"), ("speech", "fused"),
                                          ("sine", "hybrid")])
def test_params_swap_refused_where_weights_are_baked(name, backend):
    """The whole-network kernels read the weights baked into their plan at
    build, so a model on those backends refuses new params rather than
    ignoring them."""
    m = compile_tflite(model_path(name), backend=backend, device="cpu")
    with pytest.raises(ValueError, match="bakes the weights"):
        m.params = params_from_numpy(m.params, "cpu")
    m = compile_tflite(model_path(name), backend="pallas", device="cpu")
    m.params = params_from_numpy(m.params, "cpu")


def test_backend_names(tmp_path):
    path = model_path("sine")
    assert compile_tflite(path, device="cpu").backend == "xla"
    assert compile_tflite(path, backend="pallas", device="cpu").backend == "pallas"
    for name in ("flat", "colfc", "fused", "hybrid"):
        assert compile_tflite(path, backend=name, device="cpu").backend == name
    with pytest.raises(ValueError, match="not packable"):
        compile_tflite(path, backend="packed", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        compile_tflite(path, backend="tpu", device="cpu")
    u8 = synth.write(str(tmp_path / "u8.tflite"), synth.uint8_mlp())
    with pytest.raises(ValueError, match="int8 graphs only"):
        compile_tflite(u8, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="not megakernel-fusable"):
        compile_tflite(u8, backend="fused", device="cpu")
    assert compile_tflite(u8, backend="xla", device="cpu").predict_inner(
        np.zeros((2, 16), np.uint8)).dtype == torch.uint8
