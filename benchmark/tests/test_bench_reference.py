"""The plain reference against the program's plain ``xla`` path on the CPU,
and the control (int4 weights) against the reference."""

import os

import numpy as np
import pytest
import torch

from benchmark.harness import BENCH
from benchmark.reference.model import Reference, Trainer

MODELS = ("person_detect", "speech")


def model_file(name: str) -> str:
    return os.path.join(BENCH, "configs", f"{name}.tflite")


def program(name: str):
    from microflow_tpu_torch import compile_tflite

    return compile_tflite(model_file(name), name=name, backend="xla", device="cpu")


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_reference_equals_program_int8(name, seed):
    m, ref = program(name), Reference(model_file(name), "cpu")
    gen = torch.Generator().manual_seed(seed)
    xq = torch.randint(-128, 128, (4, *m.graph.input_shape), generator=gen).to(torch.int8)
    assert torch.equal(ref.forward(xq, block=3), m.predict_inner(xq))


@pytest.mark.parametrize("name", MODELS)
def test_reference_equals_program_f32(name):
    m, ref = program(name), Reference(model_file(name), "cpu")
    x = np.random.default_rng(1).uniform(0, 1, (3, *m.graph.input_shape)).astype(np.float32)
    assert torch.equal(ref.dequantize(ref.forward(ref.quantize(x))), m.predict(x))


@pytest.mark.parametrize("name", MODELS)
def test_control_departs_from_reference(name):
    ref = Reference(model_file(name), "cpu")
    ctl = Reference(model_file(name), "cpu", int4=True)
    gen = torch.Generator().manual_seed(3)
    xq = torch.randint(-128, 128, (8, *ref.graph.input_shape), generator=gen).to(torch.int8)
    assert not torch.equal(ctl.forward(xq), ref.forward(xq))


def test_reference_trainer_equals_program_one_step():
    from microflow_tpu_torch.train.trainer import compile_tflite_train

    m = compile_tflite_train(model_file("person_detect"), 10, "crossentropy", True,
                             name="person_detect", backend="xla", device="cpu")
    ref = Trainer(model_file("person_detect"), "cpu", 10, "crossentropy", True)
    gen = torch.Generator().manual_seed(11)
    xq = torch.randint(-128, 128, (4, 96, 96, 1), generator=gen).to(torch.int8)
    gt = torch.full((4, 2), -128, dtype=torch.int8)
    gt[torch.arange(4), torch.tensor([0, 1, 1, 0])] = 127
    assert torch.equal(m.predict_quantized_train(xq, gt), ref.step(xq, gt))
    assert sorted(m.grads) == sorted(ref.grads)
    for k in ref.grads:
        for n in ("weights_gradient", "c0_gradient"):
            assert torch.equal(m.grads[k][n], ref.grads[k][n]), (k, n)
    m.update_layers(4, 0.01)
    ref.update(4, 0.01)
    for k in ref.grads:
        for n in ("weights", "c0", "c2"):
            if n in ref.params[k]:
                assert torch.equal(m.params[k][n], ref.params[k][n]), (k, n)
