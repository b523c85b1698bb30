"""Residual graphs in the port: ``ADD``, the graph's wiring and its walk.

The port against the benchmark's plain reference of residual graphs
(``benchmark/reference_residual``, plain torch, independent of the port)
bit for bit, on the synthetic residual graph (``models/synth.py::
residual``) through every backend that runs on the CPU and both front
ends; the planners of the one-launch kernels refusing, or stopping
before, a layer that is not a plain link of a chain; and the paths that
run chain graphs only refusing a residual one by name."""

import dataclasses
import types

import numpy as np
import pytest
import torch
from test_torch_frontend import assert_same

from benchmark.reference_residual import model as plain
from microflow_tpu_torch.compiler import folding
from microflow_tpu_torch.compiler.builder import apply_layer, build, select_backend
from microflow_tpu_torch.compiler.fixed_forward import build_fixed_forward
from microflow_tpu_torch.compiler.ir import AddLayer, chain_length
from microflow_tpu_torch.frontend import parse
from microflow_tpu_torch.frontend.tflite import ActivationFunctionType as Act
from microflow_tpu_torch.frontend.tflite import BuiltinOperator as Op
from microflow_tpu_torch.frontend.tflite import Padding, TensorType
from microflow_tpu_torch.frontend.writer import ModelWriter
from microflow_tpu_torch.kernels.colfc import plan_col
from microflow_tpu_torch.kernels.flatpack import plan_flat
from microflow_tpu_torch.kernels.megakernel import fusable, hybrid_split_index, plan_segments
from microflow_tpu_torch.kernels.packed import plan_packed
from microflow_tpu_torch.models import model_path, synth
from microflow_tpu_torch.ops.add import add
from microflow_tpu_torch.parallel import ShardedTrainer
from microflow_tpu_torch.train.trainer import TrainableModel
from microflow_tpu_torch.utils import trace

MOBILENET = "benchmark/configs/mobilenet_v2.tflite"
CHAIN_MODELS = ("sine", "speech", "person_detect")
SYNTH_CHAINS = ("lenet", "full_ops", "flat_conv", "uint8_mlp", "per_channel_dw")


@pytest.fixture(scope="module")
def residual_path(tmp_path_factory):
    return synth.write(str(tmp_path_factory.mktemp("res") / "residual.tflite"), synth.residual())


@pytest.fixture(scope="module")
def reference(residual_path):
    return plain.Reference(residual_path, "cpu")


def rows(batch: int, shape, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-128, 128, (batch, *shape), generator=g, dtype=torch.int8)


@pytest.mark.parametrize("frontend", ["python", "native"])
@pytest.mark.parametrize("backend", ["xla", "pallas", "flat"])
@pytest.mark.parametrize("batch", [1, 7])
def test_port_matches_the_plain_reference(residual_path, reference, frontend, backend, batch):
    model = build(parse(residual_path, frontend=frontend), backend=backend, device="cpu")
    x = rows(batch, model.graph.input_shape, seed=batch)
    got, want = model.predict_inner(x), reference.forward(x)
    assert got.dtype == want.dtype == torch.int8 and got.shape == (batch, 10)
    assert torch.equal(got, want)


@pytest.mark.parametrize("path", ["residual", MOBILENET])
def test_both_front_ends_give_the_same_wired_graph(residual_path, path):
    path = residual_path if path == "residual" else path
    native, python = parse(path, frontend="native"), parse(path, frontend="python")
    assert_same(native, python)
    assert native.wiring == python.wiring and native.wiring is not None
    assert sum(isinstance(layer, AddLayer) for layer in native.layers) == (
        2 if path == residual_path else 10)


@pytest.mark.parametrize("name", CHAIN_MODELS)
def test_chain_graphs_carry_no_wiring(name):
    g = parse(model_path(name))
    assert g.wiring is None and chain_length(g) == len(g.layers)


@pytest.mark.parametrize("gen", SYNTH_CHAINS)
def test_synthetic_chains_carry_no_wiring(gen, tmp_path):
    g = parse(synth.write(str(tmp_path / f"{gen}.tflite"), getattr(synth, gen)()))
    assert g.wiring is None and chain_length(g) == len(g.layers)


def test_mobilenet_v2_graph_and_backend():
    """Table 2's network: 66 operators, 10 ADDs, a chain of 5 layers before
    the first block input read twice; ``auto`` on CUDA takes the per-op
    kernels (the flat plan refuses the 112x112x32 stem), decided on the
    host."""
    g = parse(MOBILENET)
    kinds = [type(layer).__name__ for layer in g.layers]
    assert len(kinds) == 66 and kinds.count("AddLayer") == 10
    assert kinds.count("Conv2DLayer") == 36 and kinds.count("DepthwiseConv2DLayer") == 17
    assert chain_length(g) == 5 and plan_flat(g) is None
    assert select_backend(g, "auto", "cuda") == ("pallas", None)
    assert select_backend(g, "auto", "cpu") == ("xla", None)


def test_add_constants_match_the_plain_reference():
    """The fold's integer constants of every ADD of MobileNetV2, against the
    plain reference's own derivation from the scales."""
    port = [layer for layer in parse(MOBILENET).layers if isinstance(layer, AddLayer)]
    ref = [layer for layer in plain.parse(MOBILENET).layers if isinstance(layer, plain.Add)]
    assert len(port) == len(ref) == 10
    for p, r in zip(port, ref):
        assert (p.index, p.left_shift) == (r.index, plain.LEFT_SHIFT)
        assert (p.in1_multiplier, -p.in1_shift) == r.in1
        assert (p.in2_multiplier, -p.in2_shift) == r.in2
        assert (p.out_multiplier, -p.out_shift) == r.out
        assert (p.act_min, p.act_max) == (r.lo, r.hi)
        assert (p.in1_q.zp0, p.in2_q.zp0, p.out_q.zp0) == (r.in1_zp, r.in2_zp, r.out_zp)


@pytest.mark.parametrize("m", [1e-9, 0.2, 0.5, 0.7071067811865476, 0.999999999, 2.0**-32])
def test_quantized_multiplier(m):
    q, e = folding.quantize_multiplier_smaller_than_one(m)
    if q == 0:
        assert (q, e) == (0, 0) and m < 2.0**-31
        return
    assert 2**30 <= q < 2**31 and e <= 0
    assert abs(q * 2.0 ** (e - 31) - m) <= 2.0 ** (e - 32)
    assert (q, -e) == plain.quantized_multiplier(m)


def test_walk_records_its_spans_and_live_peak(residual_path):
    """Each ADD is a span ``mft.op.add`` inside the call's ``mft.predict``;
    the counter holds the most bytes the walk held at once."""
    model = build(parse(residual_path), backend="xla", device="cpu")
    before = len(trace.records(trace.ADD_SPAN))
    model.predict_inner(rows(5, model.graph.input_shape, seed=1))
    adds = trace.records(trace.ADD_SPAN)[before:]
    call = trace.records("mft.predict")[-1]
    assert len(adds) == 2 and all(r.parent == "mft.predict" and r.ident == call.ident
                                  for r in adds)
    # block A holds its input (5 x 8x8x8), the expand (5 x 8x8x48) and the
    # depthwise output at once: 5 * (512 + 3072 + 3072) bytes
    assert trace.COUNTERS[trace.LIVE_PEAK] == 5 * (512 + 3072 + 3072)


def test_chain_graphs_keep_their_loop(monkeypatch):
    """A chain graph never enters the walk."""
    model = build(parse(model_path("speech")), backend="xla", device="cpu")
    monkeypatch.setattr(type(model), "_walk", lambda *a: pytest.fail("walked a chain"))
    model.predict_inner(rows(2, model.graph.input_shape, seed=2))


def test_flat_and_packed_stop_before_the_first_non_chain_layer(residual_path):
    g = parse(residual_path)
    assert chain_length(g) == 2  # layer 2's output is read by block A twice
    ops, n_layers, _ = plan_flat(g)
    assert n_layers == 2 and [op.layer_idx for op in ops] == [0, 1]
    assert plan_flat(g, max_layers=1) is None
    assert plan_packed(g) is None


def test_megakernel_and_colfc_refuse_a_residual_graph(residual_path):
    g = parse(residual_path)
    assert not fusable(g) and plan_col(g) is None
    assert hybrid_split_index(g) <= chain_length(g)
    with pytest.raises(ValueError, match="one chain"):
        plan_segments(g)
    for backend in ("fused", "hybrid", "packed", "colfc"):
        with pytest.raises(ValueError):
            build(g, backend=backend, device="cpu")


def test_a_planner_that_ignored_the_wiring_would_be_wrong(residual_path, reference):
    """The flat prefix with the walk after it is right; the same graph run
    as a chain is not, so the planners' stop is what keeps it right."""
    g = parse(residual_path)
    x = rows(3, g.input_shape, seed=3)
    want = reference.forward(x)
    assert torch.equal(build(g, backend="flat", device="cpu").predict_inner(x), want)
    chain = build(dataclasses.replace(g, wiring=None), backend="xla", device="cpu")
    with pytest.raises(TypeError, match="ADD reads two tensors"):
        chain.predict_inner(x)


def test_training_refuses_a_residual_graph_by_name(residual_path):
    g = parse(residual_path)
    with pytest.raises(NotImplementedError, match="ADD"):
        TrainableModel(g, 2, "crossentropy", True, device="cpu")
    stand_in = types.SimpleNamespace(graph=g, gradient_mode="quantized")
    with pytest.raises(NotImplementedError, match="ADD"):
        ShardedTrainer(stand_in, mesh=None)


def test_export_and_fixed_forward_refuse_a_residual_graph(residual_path):
    model = build(parse(residual_path), backend="xla", device="cpu")
    with pytest.raises(NotImplementedError, match="ADD"):
        model.export()
    with pytest.raises(NotImplementedError, match="ADD"):
        build_fixed_forward(model.graph)


def test_expansion_lists_the_adds(residual_path):
    g = parse(residual_path)
    text = build(g, backend="pallas", device="cpu").expansion(2)
    lines = [line for line in text.splitlines() if "] Add " in line]
    assert len(lines) == 2 and all("qadd_reference" in line for line in lines)
    assert "2x8x8x8 -> 2x8x8x8" in lines[0] and "2x4x4x16 -> 2x4x4x16" in lines[1]
    # layer 3 reads layer 2's output (8 channels), not block A's later tensors
    assert "[ 3] Conv2D                  2x8x8x8 -> 2x8x8x48" in text
    xla = build(g, backend="xla", device="cpu").expansion(1)
    assert sum("ops.add" in line for line in xla.splitlines()) == 2


@pytest.mark.parametrize("name,classes", [("person_detect", 2), ("speech", 4),
                                          (MOBILENET, 1001)])
def test_per_op_softmax_takes_qsoftmax_at_every_width(name, classes, monkeypatch):
    """On ``pallas`` every softmax goes through ``qsoftmax`` (its plain
    version here), whatever its width, and the expansion names it; ``xla``
    keeps the plain op."""
    from microflow_tpu_torch.kernels import qsoftmax as module

    g = parse(name if name == MOBILENET else model_path(name))
    layer = g.layers[-1]
    assert type(layer).__name__ == "SoftmaxLayer" and layer.out_shape[-1] == classes
    seen = []
    monkeypatch.setattr(module, "qsoftmax",
                        lambda x, **kw: seen.append(x.shape) or module.qsoftmax_reference(x, **kw))
    x = rows(3, (classes,), seed=classes)
    got = apply_layer(layer, {}, x, "pallas")
    assert seen == [(3, classes)]
    assert torch.equal(got, apply_layer(layer, {}, x, "xla")) and len(seen) == 1
    for backend, what in (("pallas", "qsoftmax_reference"), ("xla", "ops.softmax")):
        text = build(g, backend=backend, device="cpu").expansion(1)
        assert [what in line for line in text.splitlines() if "] Softmax " in line] == [True]


def test_apply_layer_refuses_an_add_alone(residual_path):
    layer = next(layer for layer in parse(residual_path).layers if isinstance(layer, AddLayer))
    with pytest.raises(TypeError, match="ADD reads two tensors"):
        apply_layer(layer, {}, torch.zeros(1, 8, 8, 8, dtype=torch.int8))


def _one_add(shape, ttype=TensorType.INT8, same_input=False, pooled=False) -> bytes:
    """``ADD(a, b)``: ``b`` is ``a`` itself, the 4x4 average pool of ``a``
    (``pooled``: a broadcast), or a tensor no operator writes."""
    m = ModelWriter("one add")
    a = m.tensor(shape, ttype, 0.05, 1, name="a")
    b = a
    if pooled:
        b = m.tensor([1, 1, 1, shape[-1]], ttype, 0.05, 1, name="pool")
        m.add_op(Op.AVERAGE_POOL_2D, [a], [b],
                 m.pool_options(Padding.VALID, (4, 4), (4, 4), Act.NONE))
    elif not same_input:
        b = m.tensor(shape, ttype, 0.04, -2, name="b")
    o = m.tensor(shape, ttype, 0.06, 3, name="o")
    m.add_op(Op.ADD, [a, b], [o], m.add_options(Act.NONE))
    return m.finish([a], [o])


def test_parser_refuses_a_broadcast_add_and_other_types(tmp_path):
    path = str(tmp_path / "m.tflite")
    synth.write(path, _one_add([1, 4, 4, 8], pooled=True))
    with pytest.raises(NotImplementedError, match="broadcast"):
        parse(path)
    synth.write(path, _one_add([1, 4], TensorType.UINT8, same_input=True))
    with pytest.raises(NotImplementedError, match="int8"):
        parse(path)


def test_parser_refuses_an_operand_no_operator_writes(tmp_path):
    """A constant or dangling ADD operand: tensor ``b`` is neither the
    graph's input nor any operator's output."""
    path = synth.write(str(tmp_path / "m.tflite"), _one_add([1, 4, 4, 8]))
    with pytest.raises(NotImplementedError, match="neither the graph's input"):
        parse(path)


def test_add_of_one_tensor_with_itself_runs_end_to_end(tmp_path):
    path = synth.write(str(tmp_path / "m.tflite"), _one_add([1, 4, 4, 8], same_input=True))
    g = parse(path)
    assert g.wiring is not None and g.wiring.layers[0][0] == (g.wiring.input,) * 2
    x = rows(3, (4, 4, 8), seed=4)
    want = add(x, x, g.layers[0])
    for backend in ("xla", "pallas"):
        assert torch.equal(build(g, backend=backend, device="cpu").predict_inner(x), want)
    assert torch.equal(plain.Reference(path, "cpu").forward(x), want)


def test_add_op_against_a_direct_integer_count():
    """``ops.add`` on every pair of int8 codes against the formula written
    out in Python integers."""
    from microflow_tpu_torch.core.activation import FusedActivation

    in1, in2, out = (folding.QuantInfo(np.array([s], np.float32), np.array([z], np.int64))
                     for s, z in ((0.031, -7), (0.047, 12), (0.052, -3)))

    layer = AddLayer(0, in1, in2, out, **folding.preprocess_add(in1, in2, out,
                                                                FusedActivation.RELU6),
                     activation=FusedActivation.RELU6, out_shape=(256, 256))
    codes = torch.arange(-128, 128, dtype=torch.int8)
    x1, x2 = codes[:, None].expand(256, 256), codes[None, :].expand(256, 256)

    def scale(v, m, e):
        ab = v * m
        hi = (ab + (1 << 30 if ab >= 0 else 1 - (1 << 30)))
        hi = -((-hi) >> 31) if hi < 0 else hi >> 31  # C++ division truncates
        r = -e
        mask = (1 << r) - 1
        return (hi >> r) + ((hi & mask) > ((mask >> 1) + (hi < 0)))

    want = np.empty((256, 256), np.int64)
    for i in range(256):
        for j in range(256):
            a = (i - 128 - in1.zp0) << 20
            b = (j - 128 - in2.zp0) << 20
            s = (scale(a, layer.in1_multiplier, layer.in1_shift)
                 + scale(b, layer.in2_multiplier, layer.in2_shift))
            y = scale(s, layer.out_multiplier, layer.out_shift) + out.zp0
            want[i, j] = min(max(y, layer.act_min), layer.act_max)
    assert np.array_equal(add(x1.contiguous(), x2.contiguous(), layer).numpy(), want)


def test_walk_folds_follow_the_params(residual_path):
    """The walk makes a conv's and a depthwise layer's weight-dependent
    operands once a ``params`` assignment and keeps them across calls; a
    write through ``.data`` (which no version counter sees) followed by an
    assignment gives the plain ops' bits on the written weights, and a
    swap the old bits back."""
    from microflow_tpu_torch.compiler.builder import init_params

    g = parse(residual_path)
    model, plain_ops = (build(g, backend=b, device="cpu") for b in ("pallas", "xla"))
    x = rows(3, g.input_shape, seed=5)
    want = model.predict_inner(x)
    first = dict(model._folds)
    assert sorted(first) == [0, 1, 2, 3, 4, 5, 7, 8, 9, 10, 11, 12, 15]
    assert torch.equal(model.predict_inner(x), want)
    assert all(model._folds[i] is f for i, f in first.items())
    for key in ("layer3", "layer4"):  # a conv and a depthwise layer
        w = model.params[key]["weights"]
        w.data.copy_(torch.flip(w, [0]))
    model.params = model.params
    assert model._folds == {}
    plain_ops.params = model.params
    changed = model.predict_inner(x)
    assert torch.equal(changed, plain_ops.predict_inner(x)) and not torch.equal(changed, want)
    assert all(model._folds[i] is not f for i, f in first.items())
    model.params = init_params(g, "cpu")
    assert model._folds == {} and torch.equal(model.predict_inner(x), want)


def test_outputs_on_the_cpu_are_returned_as_they_are():
    """``keepable`` moves only CUDA tensors (the allocator it works around is
    the card's)."""
    from microflow_tpu_torch.compiler.builder import keepable

    y = torch.zeros(1024, 1001, dtype=torch.int8)
    assert keepable(y) is y
