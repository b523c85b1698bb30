"""The port's ``TrainableModel`` (``microflow_tpu_torch/train/trainer.py``)
against the JAX package's, on the CPU, from the same params: sine (mse, one
layer), speech (crossentropy, two layers, the softmax skipped) and
person_detect (crossentropy, ten layers; also those ten layers as a graph
of their own, at a batch that gives each of them a gradient), through the
port's ``"xla"`` and ``"pallas"`` backends (the kernels' plain versions
here).  Grads after each of two steps, params after an update, and grads
after a third step on the updated weights are bit-equal to the JAX
trainer's.

The JAX trainer's update runs with jit disabled, op by op, which is the
reference's f32 order: jitted, XLA folds ``lr / B`` into one constant and
contracts ``c0 - g * k`` into a fused multiply-add, which moves C0 by an
ulp (``test_jitted_jax_update_differs_only_in_c0``).  Float mode is held to
a stated tolerance; the refused backends raise."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch_parity as tp

from microflow_tpu import models as jmodels
from microflow_tpu.frontend import parse as jparse
from microflow_tpu.train.trainer import TrainableModel as JTrainable
from microflow_tpu_torch import (
    TrainableModel,
    compile_tflite_train,
    grads_from_numpy,
    grads_to_numpy,
    parse as tparse,
)
from microflow_tpu_torch import models as tmodels
from microflow_tpu_torch.models import model_path
from microflow_tpu_torch.train import trainer as ttrainer

LR = 0.05
PD = model_path("person_detect")


def pd_suffix(graph):
    """person_detect's trained layers (21-30) as a graph of their own,
    renumbered from 0 (the JAX trainer indexes layers by number): its input
    is layer 20's output."""
    layers = [dataclasses.replace(layer, index=i) for i, layer in enumerate(graph.layers[21:])]
    return dataclasses.replace(graph, layers=layers, input_shape=tuple(graph.layers[20].out_shape),
                               input_q=layers[0].in_q)


# name -> (the JAX and the port trainer, batch, seed).  At each seed the JAX
# XLA chain meets no element where its fused multiply-add rounds otherwise
# than the reference (asserted); the suffix's seed also gives every trained
# layer a nonzero gradient (asserted; at batch 4 person_detect's layers
# 21-24 get none).
CASES = {
    "sine": (lambda: jmodels.sine_trainable(),
             lambda **kw: tmodels.sine_trainable(**kw), 4, 0),
    "speech": (lambda: jmodels.speech_trainable(),
               lambda **kw: tmodels.speech_trainable(**kw), 3, 0),
    "person_detect": (lambda: jmodels.person_detect_trainable(10),
                      lambda **kw: tmodels.person_detect_trainable(10, **kw), 4, 2),
    "person_detect_suffix": (
        lambda: JTrainable(pd_suffix(jparse(PD, frontend="python")), 10, "crossentropy", True),
        lambda **kw: TrainableModel(pd_suffix(tparse(PD)), 10, "crossentropy", True, **kw),
        32, 9),
}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def inputs(name, jm, batch, seed):
    rng = np.random.default_rng(seed)
    shape = jm.graph.input_shape
    if name == "sine":
        x = rng.uniform(0, 2 * np.pi, (batch, *shape)).astype(np.float32)
        return np.asarray(jm.quantize_input(x)), np.asarray(jm.quantize_target(x / 4))
    xq = rng.integers(-128, 128, (batch, *shape), dtype=np.int8)
    # one-hot labels on the softmax's grid (scale 1/256, zero point -128)
    label = np.full((batch, jm.graph.output_shape[-1]), -128, np.int8)
    label[np.arange(batch), rng.integers(0, 2, batch)] = 127
    return xq, label


def no_fma_set(jm, xq):
    sets = tp.chain_sets(jm.graph, jm.params, xq)
    assert sets["fma"] == 0, f"pick another seed: the JAX chain meets {sets['fma']} FMA elements"


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trainer's trajectory, once a case: outputs and grads after
    steps 1 and 2, params after the update (eager, and jitted), output and
    grads after step 3."""
    runs = {}
    for name, (make_jax, _, batch, seed) in CASES.items():
        jm = make_jax()
        xq, gt = inputs(name, jm, batch, seed)
        no_fma_set(jm, xq)
        params0 = np_tree(jm.params)
        run = {"xq": xq, "gt": gt, "params0": params0, "out": [], "grads": []}
        for _ in range(2):
            run["out"].append(np.asarray(jm.predict_quantized_train(xq, gt, LR)))
            run["grads"].append(np_tree(jm.grads))
        grads2 = jm.grads
        jm.update_layers(batch, LR)
        run["params_jit"] = np_tree(jm.params)
        jm.params = jax.tree_util.tree_map(jax.numpy.asarray, params0)  # eager update
        jm.grads = grads2
        with jax.disable_jit():
            jm.update_layers(batch, LR)
        run["params"] = np_tree(jm.params)
        no_fma_set(jm, xq)
        run["out"].append(np.asarray(jm.predict_quantized_train(xq, gt, LR)))
        run["grads"].append(np_tree(jm.grads))
        runs[name] = run
    return runs


def assert_tree_equal(port: dict, ref: dict, what: str):
    assert port.keys() == ref.keys(), what
    for layer, arrays in ref.items():
        assert port[layer].keys() == arrays.keys(), (what, layer)
        for k, want in arrays.items():
            got = port[layer][k]
            assert got.dtype == want.dtype and got.shape == want.shape, (what, layer, k)
            assert got.tobytes() == want.tobytes(), (
                what, layer, k, int((got != want).sum()), np.argwhere(got != want)[:5])


def port_params(tm):
    return {k: {kk: v.cpu().numpy() for kk, v in d.items()} for k, d in tm.params.items()}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(CASES))
def test_trainer_matches_jax(jax_runs, name, backend):
    run = jax_runs[name]
    tm = CASES[name][1](backend=backend, device="cpu")
    assert tm.backend == backend
    assert_tree_equal(port_params(tm), run["params0"], "params0")
    for step in range(3):
        if step == 2:
            tm.update_layers(len(run["xq"]), LR)
            assert_tree_equal(port_params(tm), run["params"], "params after the update")
        out = tm.predict_quantized_train(run["xq"], run["gt"], LR)
        assert out.numpy().tobytes() == run["out"][step].tobytes()
        assert_tree_equal(grads_to_numpy(tm.grads), run["grads"][step], f"grads, step {step}")
        if step == 0:
            # carry the JAX trainer's state across (the same values): the
            # fold's bound is then read from the tensors
            tm.grads = grads_from_numpy(run["grads"][0], "cpu")
            assert tm._fold_bound is None
    nonzero = {k: int(np.count_nonzero(v["weights_gradient"])) for k, v in run["grads"][1].items()}
    assert any(nonzero.values()), nonzero
    if name != "person_detect":
        assert all(nonzero.values()), nonzero


def test_jitted_jax_update_differs_only_in_c0(jax_runs):
    """A property of the JAX reference on the CPU, recorded so the eager
    comparison above is not mistaken for a tolerance: the jitted update
    gives other bits than the op-by-op one in C0 only (the f32 step
    ``c0 - lr * g / B`` computed as one FMA with ``lr / B`` folded)."""
    moved = 0
    for run in jax_runs.values():
        for layer, arrays in run["params"].items():
            for k, eager in arrays.items():
                jit = run["params_jit"][layer][k]
                if k != "c0":
                    assert np.array_equal(jit, eager), (layer, k)
                else:
                    np.testing.assert_allclose(jit, eager, rtol=0,
                                               atol=1e-6 * np.abs(eager).max())
                    moved += int((jit != eager).sum())
    assert moved > 0


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_float_mode_on_sine_within_tolerance(backend):
    """gradient_mode="float": the f32 FC gradients sum in another order
    than XLA's.  The grads are held to 1e-6 of their largest entry; the
    int8 weights after an update to 1 LSB (the count that differ is
    printed); C0 to 1e-6 of its largest entry."""
    jm = jmodels.sine_trainable(gradient_mode="float")
    tm = tmodels.sine_trainable(backend=backend, gradient_mode="float", device="cpu")
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 2 * np.pi, (16, 1)).astype(np.float32)
    gt = np.asarray(jm.quantize_target(x / 4))
    for _ in range(2):
        jm.predict_train(x, gt, LR)
        tm.predict_train(x, gt, LR)
    jg, tg = np_tree(jm.grads), grads_to_numpy(tm.grads)
    for layer, arrays in jg.items():
        for k, want in arrays.items():
            assert tg[layer][k].dtype == np.float32
            np.testing.assert_allclose(tg[layer][k], want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
    with jax.disable_jit():
        jm.update_layers(16, LR)
    tm.update_layers(16, LR)
    jp, tp = np_tree(jm.params), port_params(tm)
    for layer, arrays in jp.items():
        w_diff = np.abs(tp[layer]["weights"].astype(np.int32) - arrays["weights"].astype(np.int32))
        print(f"{layer}: {int((w_diff > 0).sum())} of {w_diff.size} weights differ")
        assert w_diff.max() <= 1
        np.testing.assert_allclose(tp[layer]["c0"], arrays["c0"], rtol=0,
                                   atol=1e-6 * np.abs(arrays["c0"]).max())


def test_float_mode_refuses_a_conv_suffix():
    with pytest.raises(NotImplementedError, match="FC suffixes only"):
        compile_tflite_train(model_path("person_detect"), 10, "crossentropy", True,
                             gradient_mode="float", device="cpu")


@pytest.mark.parametrize("backend,name", [("flat", "person_detect"), ("colfc", "sine"),
                                          ("fused", "speech"), ("hybrid", "person_detect"),
                                          ("packed", "person_detect")])
def test_baked_backends_refuse_to_train(backend, name):
    """Each backend that bakes the weights into its plan raises, before it
    builds anything; nothing trains on another backend in its place."""
    with pytest.raises(ValueError, match="cannot train"):
        CASES[name][1](backend=backend, device="cpu")


@pytest.mark.parametrize("name", ["person_detect", "speech"])
def test_auto_refused_where_it_resolves_to_flat(name, monkeypatch):
    """``"auto"`` on CUDA resolves to ``"flat"`` for these two: refused
    (checked without a card: the refusal comes before any device work)."""
    monkeypatch.setattr(ttrainer, "resolve_device", lambda device=None: torch.device("cuda"))
    with pytest.raises(ValueError, match="'flat' bakes"):
        CASES[name][1](backend="auto", device="cuda")


def test_auto_on_the_cpu_is_xla_and_no_device_means_cuda():
    assert tmodels.sine_trainable(backend="auto", device="cpu").backend == "xla"
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmodels.sine_trainable(device=device)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sine_retarget_converges(backend):
    """The reference's sine_train.rs task, retarget sin(x) -> x/4 (the
    port's counterpart of tests/test_train.py's)."""
    m = tmodels.sine_trainable(backend=backend, device="cpu")
    rng = np.random.default_rng(0)
    lr, batch = 0.01, 64

    def mse():
        xs = rng.uniform(0, 2 * np.pi, (256, 1)).astype(np.float32)
        return float(np.mean((m.predict(xs).numpy() - xs / 4) ** 2))

    before = mse()
    for _ in range(60):
        xs = rng.uniform(0, 2 * np.pi, (batch, 1)).astype(np.float32)
        m.predict_train(xs, m.quantize_target(xs / 4), lr)
        m.update_layers(batch, lr)
    after = mse()
    assert after < before / 3, (before, after)
