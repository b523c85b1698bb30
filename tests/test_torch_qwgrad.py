"""The 1x1 convs' folded weight gradients (``kernels/qwgrad.py``,
``csrc/qwgrad.cu``) and the trainer's rule for when they run.

CPU tests: the plain version is the trainer's chain (``conv_backward_sample``'s
per-sample gradient, then ``accumulate_gradient_4d_fold``) at
person_detect's four 1x1 shapes; a numpy emulation of the kernel's own
arithmetic (wrapping u32 sums, a branch for a zero norm, the clamp before
the rounding) equals it on every planted edge of ``chip_smoke.qwgrad_cases``;
the path rule; the trainer's kernel path (with the plain version standing
in for the kernel) bit-equal to its plain path, eager and replayed, and
counted.  The ``cuda``-marked tests hold the kernel to its plain version
on the card.  This file imports neither JAX nor ``microflow_tpu``."""

import dataclasses
import types

import chip_smoke
import numpy as np
import pytest
import torch

from microflow_tpu_torch.kernels import LAUNCHES, qwgrad
from microflow_tpu_torch.models import person_detect_trainable
from microflow_tpu_torch.train import gradients, optimizer
from microflow_tpu_torch.utils import trace

import test_torch_train_graphs as tg
from test_torch_train_graphs import cpu_graphs  # noqa: F401  (a fixture)

CUDA = torch.device("cuda")


@pytest.fixture(scope="module")
def graph():
    return person_detect_trainable(10, device="cpu").graph


def emulate(layer, x, md, acc) -> np.ndarray:
    """The kernel's arithmetic in numpy, from its formulas."""
    F_, _, _, C = layer.filters.shape
    B, P = x.shape[0], layer.geom.out_rows * layer.geom.out_cols
    xc = x.numpy().reshape(B, P, C).astype(np.int64) - layer.in_q.zp0
    m = md.numpy().reshape(B, P, F_)
    dw = np.matmul(m.astype(np.int64).transpose(0, 2, 1), xc).astype(np.int32)  # wraps
    norm = np.abs(m).astype(np.int64).sum(1).astype(np.int32)[..., None]  # |INT_MIN| wraps
    with np.errstate(divide="ignore", invalid="ignore"):
        y = np.clip(dw.astype(np.float32) / norm.astype(np.float32), -128, 127)
    t = np.trunc(y)
    q = np.where(np.abs(y - t) >= 0.5, t + np.copysign(np.float32(1), y), t)
    zero = np.where(dw > 0, 127, np.where(dw < 0, -128, 0))
    q = np.where(norm == 0, zero, q).astype(np.int64)
    return (acc.numpy().reshape(F_, C).astype(np.int64) + q.sum(0)).astype(np.int32).reshape(
        acc.shape)


@pytest.mark.parametrize("index", chip_smoke.PD_POINTWISE)
def test_the_plain_version_is_the_trainers_chain(graph, index):
    """At person_detect's 1x1 shapes (P 36, 9, 9, 1; F 128, 256, 256, 2),
    from a real mask of random outputs: the plain version equals
    ``conv_backward_sample``'s per-sample gradient folded by
    ``accumulate_gradient_4d_fold`` with the bound the trainer holds."""
    layer = graph.layers[index]
    gen = torch.Generator().manual_seed(index)
    x, _, acc = chip_smoke.qwgrad_inputs(layer, 6, gen)
    out_q = torch.randint(-128, 128, (6, *layer.out_shape), generator=gen, dtype=torch.int8)
    d_out = torch.randint(-2**20, 2**20, out_q.shape, generator=gen, dtype=torch.int32)
    weights = torch.tensor(layer.filters)
    wzp = torch.zeros(layer.filters.shape[0], dtype=torch.int64)
    dW_b, _, g = gradients.conv_backward_sample(layer, x, out_q, weights, d_out, wzp)
    bound = int(acc.abs().max())
    want = optimizer.accumulate_gradient_4d_fold(dW_b, acc, bound)
    md = gradients.mask_d_out(layer, out_q, d_out)
    got = qwgrad.qwgrad(layer, x, md, acc)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(g, gradients.conv_input_grad(layer, md, weights, wzp))
    assert torch.equal(torch.from_numpy(emulate(layer, x, md, acc)), want)


def test_the_emulated_kernel_meets_the_plain_version_on_every_planted_edge(graph):
    gen = torch.Generator().manual_seed(5)
    cases = chip_smoke.qwgrad_cases(graph, 5, gen)
    assert [c[0] for c in cases[4:]] == ["edges", "edges_zp127", "edges_zp0", "edges_f70_c67",
                                         "edges_f2_c5", "edges_p56"]
    for name, layer, x, md, acc in cases:
        want = qwgrad.qwgrad_reference(layer, x, md, acc)
        assert torch.equal(torch.from_numpy(emulate(layer, x, md, acc)), want), name


def test_the_planted_edges_reach_what_they_are_for(graph):
    """The planted columns give the quotients they are there for: 0/0,
    +-x/0 through a wrapped norm, both rails, and exact .5 ties."""
    layer = graph.layers[24]
    x, md, _ = chip_smoke.qwgrad_edge_inputs(layer, 13, torch.Generator().manual_seed(1))
    per = [gradients.conv_weight_grad_sample(layer, x[b:b + 1], md[b:b + 1])[0, b % 256, 0, 0]
           for b in range(6)]
    xc = x.reshape(13, 9, -1).to(torch.int64) + 128
    assert not per[0].any()  # all zero
    # two INT_MINs: norm 0, dw INT_MIN * (x0 + x1 + 256) wraps to 0 or INT_MIN
    odd = (xc[1, 0] + xc[1, 1]) % 2 == 1
    assert torch.equal(per[1], torch.where(odd, -128, 0).to(torch.int8))
    assert torch.equal(per[2], xc[2, 0].clamp(max=127).to(torch.int8))  # 1 * xc: past 127
    assert torch.equal(per[3], (-xc[3, 0]).clamp(min=-128).to(torch.int8))
    ties = (xc[4, 0] + xc[4, 1]) % 2 == 1
    assert ties.any()
    half_away = torch.div(xc[4, 0] + xc[4, 1] + 1, 2, rounding_mode="floor")
    assert torch.equal(per[4][ties].to(torch.int64), half_away[ties].clamp(max=127))


def test_the_cpu_runs_the_plain_version_and_another_device_raises(graph):
    layer = graph.layers[24]
    x, md, acc = chip_smoke.qwgrad_inputs(layer, 3, torch.Generator().manual_seed(2))
    before = LAUNCHES["qwgrad"]
    assert torch.equal(qwgrad.qwgrad(layer, x, md, acc), qwgrad.qwgrad_reference(layer, x, md, acc))
    assert LAUNCHES["qwgrad"] == before  # the CPU launches nothing
    with pytest.raises(ValueError, match="unsupported device"):
        qwgrad.qwgrad(layer, x.to("meta"), md.to("meta"), acc.to("meta"))


# --- the path rule -----------------------------------------------------------------


def batch_like(shape, device=CUDA, dtype=torch.int8):
    """What the rule reads of a batch, on a device the CPU cannot hold."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype, shape=shape)


def test_the_rule_takes_the_kernel_for_cuda_quantized_pointwise_and_a_plain_sum_bound(graph):
    x = batch_like((1024, 3, 3, 128))
    for index in chip_smoke.PD_POINTWISE:
        assert qwgrad.takes_kernel(graph.layers[index], x, "quantized", 0)
    layer = graph.layers[24]
    bound = 2**31 - 1 - optimizer.fold_margin(1024)  # the last bound of a plain sum
    assert qwgrad.takes_kernel(layer, x, "quantized", bound)
    assert not qwgrad.takes_kernel(layer, x, "quantized", bound + 1)  # may saturate
    assert not qwgrad.takes_kernel(layer, x, "quantized", None)  # no host bound
    assert not qwgrad.takes_kernel(layer, x, "float", 0)
    assert not qwgrad.takes_kernel(layer, batch_like((1024, 3, 3, 128), "cpu"), "quantized", 0)
    assert not qwgrad.takes_kernel(layer, batch_like((1024, 3, 3, 128), dtype=torch.uint8),
                                   "quantized", 0)
    assert not qwgrad.takes_kernel(graph.layers[23], x, "quantized", 0)  # depthwise
    # a 3x3 conv, and a 1x1 conv at stride 2
    three = dataclasses.replace(
        layer, filters=np.zeros((256, 3, 3, 128), np.int8),
        geom=dataclasses.replace(layer.geom, k_rows=3, k_cols=3))
    assert not qwgrad.takes_kernel(three, x, "quantized", 0)
    strided = dataclasses.replace(
        layer, geom=dataclasses.replace(layer.geom, stride_rows=2, stride_cols=2))
    assert not qwgrad.takes_kernel(strided, x, "quantized", 0)


# --- the trainer's kernel path, with the plain version as the kernel ---------------


@pytest.fixture
def kernel_on_cpu(monkeypatch):
    """The rule as on the card, for CPU batches: the kernel path runs, with
    ``qwgrad``'s plain version in the kernel's place."""
    rule = qwgrad.takes_kernel
    monkeypatch.setattr(qwgrad, "takes_kernel",
                        lambda layer, x, *a: rule(layer, batch_like(x.shape, CUDA, x.dtype), *a))


def wgrad_counts() -> tuple[int, int]:
    return trace.COUNTERS[trace.WGRAD_FOLDS], trace.COUNTERS[trace.WGRAD_PLAIN]


def plain_run(monkeypatch, model, *args) -> list:
    """``tg.run`` with every conv on the plain path."""
    with monkeypatch.context() as mp:
        mp.setattr(qwgrad, "takes_kernel", lambda *a: False)
        return tg.run(model, *args)


@pytest.mark.parametrize("backend,loss", [("pallas", "crossentropy"), ("xla", "mse")])
def test_the_kernel_path_is_bit_equal_to_the_plain_path_eager(backend, loss, kernel_on_cpu,
                                                              monkeypatch):
    m = tg.trainer("person_detect", backend, "cpu", loss)
    data = tg.batches(m, 4, 3, seed=3)
    before = wgrad_counts()
    got = tg.run(m, data)
    assert wgrad_counts() == (before[0] + 12, before[1])
    steps = trace.records("mft.train.step")[-3:]
    assert [dict(r.counts) for r in steps] == [{trace.EAGER_STEPS: 1, trace.WGRAD_FOLDS: 4}] * 3
    tg.assert_same_states(got, plain_run(monkeypatch, tg.trainer("person_detect", backend,
                                                                 "cpu", loss), data))


def test_replayed_steps_count_the_layers_their_capture_folded(kernel_on_cpu, cpu_graphs,
                                                              monkeypatch):
    m, ref = (tg.trainer("person_detect", "pallas", "cpu") for _ in range(2))
    tg.eager(ref, monkeypatch)
    data = tg.batches(m, 4, 5, seed=4)
    got = tg.run(m, data)
    steps = trace.records("mft.train.step")[-5:]
    assert [dict(r.counts) for r in steps] == (
        [{trace.EAGER_STEPS: 1, trace.WGRAD_FOLDS: 4}]
        + [{trace.GRAPH_STEPS: 1, trace.WGRAD_FOLDS: 4}] * 4)
    tg.assert_same_states(got, plain_run(monkeypatch, ref, data))


def test_a_saturating_fold_takes_the_plain_path_on_the_kernels_device(kernel_on_cpu,
                                                                      monkeypatch):
    """An accumulator at the serial fold's edge: the step reads the bound,
    which admits no plain sum, so every conv takes the plain path."""
    m = tg.trainer("person_detect", "pallas", "cpu")
    ref = tg.trainer("person_detect", "pallas", "cpu")
    data = tg.batches(m, 4, 6, seed=1)
    before = wgrad_counts()
    got = tg.run(m, data, tg.LRS, tg.edits)
    assert wgrad_counts()[1] - before[1] == 4  # step 4, the edited one
    assert wgrad_counts()[0] - before[0] == 4 * 5
    tg.assert_same_states(got, plain_run(monkeypatch, ref, data, tg.LRS, tg.edits))


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return CUDA


@pytest.mark.cuda
def test_the_kernel_matches_its_plain_version_on_the_card(cuda, graph):
    gen = torch.Generator().manual_seed(9)
    for name, layer, x, md, acc in chip_smoke.qwgrad_cases(graph, 256, gen):
        x, md, acc = x.to(cuda), md.to(cuda), acc.to(cuda)
        before = LAUNCHES["qwgrad"]
        got = qwgrad.qwgrad(layer, x, md, acc)
        assert LAUNCHES["qwgrad"] == before + 1
        assert torch.equal(got, qwgrad.qwgrad_reference(layer, x, md, acc)), name
        assert torch.equal(got.cpu(), qwgrad.qwgrad_reference(layer, x.cpu(), md.cpu(),
                                                              acc.cpu())), name


@pytest.mark.cuda
def test_a_trainer_on_the_card_is_bit_equal_to_one_on_the_cpu(cuda):
    res = chip_smoke.wgrad_step_check(cuda, batch=32, steps=3)
    assert res["counters"] == {trace.WGRAD_FOLDS: 12, trace.WGRAD_PLAIN: 12}


@pytest.mark.cuda
def test_a_captured_backward_replays_the_kernel_bit_equal(cuda, monkeypatch):
    """Graph steps launch 4 ``qwgrad`` a step (counted at replay) and equal
    eager steps that take the plain path on the card."""
    m, ref = (tg.trainer("person_detect", "xla", cuda) for _ in range(2))
    tg.eager(ref, monkeypatch)
    data = tg.batches(m, 256, 4)
    want = plain_run(monkeypatch, ref, data)
    LAUNCHES.clear()
    got = tg.run(m, data)
    torch.cuda.synchronize(cuda)
    assert LAUNCHES["qwgrad"] == 16
    tg.assert_same_states(got, want)
