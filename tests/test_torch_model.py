"""The torch port end to end on the CPU: the three Rust goldens bit-exact
through both backends, and per-layer teacher-forced parity with the JAX
package (each port layer gets the JAX layer's input, so a one-LSB
FMA-contraction difference cannot spread) on the bundled models and the
synthetic zoo."""

import jax
import numpy as np
import pytest
import torch
import torch_parity as tp

from microflow_tpu.compiler.builder import init_params as j_init_params
from microflow_tpu.frontend import parse as jparse
from microflow_tpu.models import synth
from microflow_tpu_torch import compile_tflite, params_from_numpy
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.models import GOLDENS, model_path

BUNDLED = ("sine", "speech", "person_detect")
SYNTH = ("lenet", "full_ops", "flat_conv", "uint8_mlp", "per_channel_dw")


@pytest.mark.parametrize("backend", ["xla", "pallas", "auto"])
@pytest.mark.parametrize("name", BUNDLED)
def test_golden_bit_exact(name, backend):
    x, want = GOLDENS[name]
    m = compile_tflite(model_path(name), name=name, backend=backend, device="cpu")
    got = m.predict(x)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def test_predict_quantized_and_inner():
    sine = compile_tflite(model_path("sine"), device="cpu")
    xq = sine.quantize_input(np.array([[0.5]], np.float32))
    assert sine.predict_quantized(xq)[0, 0].item() == np.float32(0.41348344)
    speech = compile_tflite(model_path("speech"), backend="pallas", device="cpu")
    yq = speech.predict_inner(speech.quantize_input(np.full((1, 1960), 0.5, np.float32)))
    assert yq.dtype == torch.int8 and yq.tolist() == [[-88, -58, -58, -52]]
    speech.warm(3)
    assert speech.predict(np.full((1, 1960), 0.5, np.float32)).tolist() == GOLDENS["speech"][
        1].tolist()


def test_person_detect_batched_consistency():
    m = compile_tflite(model_path("person_detect"), backend="pallas", device="cpu")
    xs = np.random.default_rng(42).uniform(0.0, 1.0, (3, 96, 96, 1)).astype(np.float32)
    batched = m.predict(xs).numpy()
    singles = np.concatenate([m.predict(xs[i:i + 1]).numpy() for i in range(3)])
    assert np.array_equal(batched, singles)


def _paths(name, tmp_path):
    if name in BUNDLED:
        return model_path(name)
    return synth.write(str(tmp_path / f"{name}.tflite"), getattr(synth, name)())


def _input(graph, batch, rng):
    info = np.iinfo(graph.input_dtype)
    return rng.integers(info.min, info.max + 1, (batch, *graph.input_shape),
                        dtype=graph.input_dtype)


@pytest.mark.parametrize("name", BUNDLED + SYNTH)
def test_teacher_forced_parity(name, tmp_path):
    path = _paths(name, tmp_path)
    jg, tg = jparse(path, frontend="python"), tparse(path)
    jparams = j_init_params(jg)
    rng = np.random.default_rng(0)
    x0 = _input(jg, 2 if name == "person_detect" else 16, rng)
    backends = ("xla",) if jg.input_dtype == np.uint8 else ("xla", "pallas")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tp.teacher_forced(jg, tg, jparams, tparams, x0, backends)
