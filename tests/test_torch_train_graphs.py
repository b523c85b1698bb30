"""The train step as CUDA graphs (``train/graphs.py``) and the resident
constants that make it capturable (``core/numerics.py``).

CPU tests: after the first step a step copies no host value to the
device; the resident constants are bit-equal to fresh ones and survive
their eviction where a graph holds them; the keys pick the eager path on
the CPU and for the serial fold; the static trees copy in only what
changed; held tensors keep their values.  The graphs' bookkeeping runs on
the CPU too (``cpu_graphs``: keys that admit the CPU and a stand-in whose
replay runs the phase again into the capture's outputs), held to the
eager steps bit for bit.  The ``cuda``-marked tests do the same with real
CUDA graphs on the card.  This file imports neither JAX nor
``microflow_tpu``."""

import numpy as np
import pytest
import torch

from microflow_tpu_torch.core import numerics
from microflow_tpu_torch.models import model_path, sine_trainable, speech_trainable
from microflow_tpu_torch.train import graphs
from microflow_tpu_torch.train.trainer import compile_tflite_train
from microflow_tpu_torch.utils import trace

EDGE = -2**31 + 10
LR = 0.01
CUDA = torch.device("cuda")


def trainer(name: str, backend: str, device, loss: str = "crossentropy",
            gradient_mode: str = "quantized"):
    if name == "person_detect":
        return compile_tflite_train(model_path("person_detect"), 10, loss, True,
                                    name="person_detect", backend=backend, device=device)
    make = sine_trainable if name == "sine" else speech_trainable
    return make(backend=backend, gradient_mode=gradient_mode, device=device)


def batches(model, n: int, steps: int, seed: int = 0) -> list:
    """Seeded int8 inputs and labels (one-hot on the output's grid)."""
    gen = torch.Generator().manual_seed(seed)
    g = model.graph
    out = []
    for _ in range(steps):
        x = torch.randint(-128, 128, (n, *g.input_shape), dtype=torch.int8, generator=gen)
        gt = torch.full((n, *g.output_shape), -128, dtype=torch.int8)
        cls = torch.randint(0, g.output_shape[-1], (n,), generator=gen)
        gt.reshape(n, -1)[torch.arange(n), cls] = 127
        out.append((x.to(model.device), gt.to(model.device)))
    return out


def tree(t: dict) -> dict:
    return {k: {n: v.clone() for n, v in sub.items()} for k, sub in t.items()}


def same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].keys() == b[k].keys() and all(torch.equal(a[k][n], b[k][n]) for n in a[k])
        for k in a)


def run(model, data: list, lrs=None, between=None) -> list:
    """Each step's output, the grads after its predict, the params after its
    update; ``between(model, i)`` runs before step i."""
    states = []
    for i, (x, gt) in enumerate(data):
        if between is not None:
            between(model, i)
        out = model.predict_quantized_train(x, gt)
        grads = tree(model.grads)
        model.update_layers(x.shape[0], LR if lrs is None else lrs[i])
        states.append((out, grads, tree(model.params)))
    return states


def assert_same_states(got: list, want: list) -> None:
    for i, ((o, g, p), (wo, wg, wp)) in enumerate(zip(got, want)):
        assert torch.equal(o, wo), f"output of step {i}"
        assert same(g, wg), f"grads after step {i}"
        assert same(p, wp), f"params after update {i}"


def eager(model, monkeypatch) -> None:
    """This model runs every phase eager."""
    monkeypatch.setattr(model, "_replayed_step", lambda *a: None)
    monkeypatch.setattr(model, "_replayed_update", lambda *a: False)


def counters() -> tuple[int, int]:
    return trace.COUNTERS[trace.GRAPH_STEPS], trace.COUNTERS[trace.EAGER_STEPS]


class ReplayedOnCpu:
    """A stand-in for ``graphs.PhaseGraph`` on the CPU: the first replay
    runs the phase and keeps what it returned as the output; each later
    replay runs it again and copies what it returns into that output, as a
    graph writes its output's addresses."""

    def __init__(self, fn, pool):
        self.fn, self.out = fn, None

    def replay(self):
        new = self.fn()
        if self.out is None:
            self.out = new
        else:
            self._copy(self.out, new)
        return self.out

    def _copy(self, old, new) -> None:
        if torch.is_tensor(old):
            old.copy_(new)
        elif isinstance(old, dict):
            for k in old:
                self._copy(old[k], new[k])
        elif isinstance(old, (tuple, list)):
            for a, b in zip(old, new):
                self._copy(a, b)


@pytest.fixture
def cpu_graphs(monkeypatch):
    key, update_key = graphs.step_key, graphs.update_key
    monkeypatch.setattr(graphs, "step_key", lambda device, *a: key(CUDA, *a))
    monkeypatch.setattr(graphs, "update_key", lambda device, *a: update_key(CUDA, *a))
    monkeypatch.setattr(graphs, "PhaseGraph", ReplayedOnCpu)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)


# --- the resident constants --------------------------------------------------


@pytest.mark.parametrize("name,backend,mode", [("person_detect", "xla", "quantized"),
                                               ("person_detect", "pallas", "quantized"),
                                               ("speech", "pallas", "quantized"),
                                               ("sine", "xla", "float")])
def test_after_the_first_step_a_step_uploads_no_host_value(name, backend, mode, monkeypatch):
    m = trainer(name, backend, "cpu", gradient_mode=mode)
    data = batches(m, 4, 3)
    run(m, data[:1])
    uploads = []
    upload = numerics._upload
    monkeypatch.setattr(numerics, "_upload",
                        lambda value, *a, **k: uploads.append(np.shape(value)) or upload(
                            value, *a, **k))
    run(m, data[1:])
    assert uploads == []


VALUES = [0.1, -0.0, float("nan"), 1e-45, 3.4e38, [0.5, -2.0, 7.25], np.float64(1 / 3),
          np.arange(12, dtype=np.float32).reshape(3, 4) / 7]


@pytest.mark.parametrize("value", VALUES, ids=range(len(VALUES)))
def test_a_resident_f32_constant_is_bit_equal_to_a_fresh_one(value):
    fresh = torch.as_tensor(np.asarray(value, np.float32), device="cpu")
    got = numerics.const_f32(value, "cpu")
    assert got.dtype == torch.float32 and got.shape == fresh.shape
    assert torch.equal(got.view(torch.int32), fresh.view(torch.int32))
    assert numerics.const_f32(value, torch.device("cpu")) is got


@pytest.mark.parametrize("value,dtype", [([1, -2, 3], None), (np.array([4, 5], np.int32), None),
                                         (np.array([[True, False]]), torch.int32),
                                         (np.array([[True, False]]), torch.int64), (7, None)])
def test_a_resident_int_constant_is_bit_equal_to_a_fresh_one(value, dtype):
    fresh = torch.as_tensor(np.asarray(value), dtype=dtype, device="cpu")
    got = numerics.const_int(value, "cpu", dtype)
    assert got.dtype == fresh.dtype and torch.equal(got, fresh)
    assert numerics.const_int(value, "cpu", dtype) is got


def test_a_resident_constant_is_its_own_copy_of_the_array():
    arr = np.array([1.5, 2.5], np.float32)
    got = numerics.const_f32(arr, "cpu")
    arr[0] = 9.0  # the caller changes its array: the constant of the old bits stays
    assert got.tolist() == [1.5, 2.5]
    assert numerics.const_f32(arr, "cpu").tolist() == [9.0, 2.5]


def test_a_pinned_constant_outlives_its_eviction(monkeypatch):
    monkeypatch.setattr(numerics, "RESIDENT_CAP", 2)
    with numerics.pinned() as pins:
        kept = numerics.const_f32(123.25, "cpu")
    assert pins == [kept]
    for v in (1.25, 2.25, 3.25):
        numerics.const_f32(v, "cpu")
    again = numerics.const_f32(123.25, "cpu")  # evicted: made again
    assert again is not kept and torch.equal(again, kept) and kept.item() == 123.25


# --- the keys ----------------------------------------------------------------


def test_the_key_picks_eager_on_the_cpu_and_for_the_serial_fold():
    x = torch.zeros((8, 96, 96, 1), dtype=torch.int8)
    gt = torch.zeros((8, 2), dtype=torch.int8)
    key = graphs.step_key(CUDA, x, gt, "quantized", 0)
    assert key == ((8, 96, 96, 1), torch.int8, (8, 2), torch.int8, "quantized")
    assert graphs.step_key(torch.device("cpu"), x, gt, "quantized", 0) is None
    assert graphs.step_key(CUDA, x, gt, "quantized", EDGE * -1) is None  # may saturate
    assert graphs.step_key(CUDA, x, gt, "quantized", None) is None  # the bound was read
    assert graphs.step_key(CUDA, x[:0], gt[:0], "quantized", 0) is None
    assert graphs.step_key(CUDA, x[:4], gt[:4], "quantized", 0) != key
    assert graphs.step_key(CUDA, x, gt, "float", 0) != key
    assert graphs.update_key(CUDA, 1024, 0.01) == (1024, 0.01)
    assert graphs.update_key(CUDA, 1024, 0.02) != graphs.update_key(CUDA, 1024, 0.01)
    assert graphs.update_key(torch.device("cpu"), 1024, 0.01) is None
    assert graphs.update_key(CUDA, 1024, torch.tensor(0.01)) is None


def test_a_cpu_model_runs_and_counts_eager_steps():
    m = trainer("sine", "xla", "cpu", gradient_mode="quantized")
    data = batches(m, 4, 3)
    before = counters()
    run(m, data)
    graph_steps, eager_steps = counters()
    assert (graph_steps, eager_steps) == (before[0], before[1] + 3)
    assert m._step_graphs == {} and m._update_graphs == {}
    steps = trace.records("mft.train.step")[-3:]
    assert all(dict(r.counts) == {trace.EAGER_STEPS: 1} for r in steps)


# --- the static trees ----------------------------------------------------------


def test_the_static_trees_copy_in_what_changed_and_refuse_another_shape():
    held = {"a": {"w": torch.arange(4), "c": torch.ones(2)}}
    st = graphs.StaticTrees()
    assert st.sync("p", held)
    static = st.trees["p"]
    assert static["a"]["w"] is not held["a"]["w"] and torch.equal(static["a"]["w"], held["a"]["w"])
    versions = {n: t._version for n, t in static["a"].items()}
    assert st.sync("p", held)  # nothing changed: nothing copied
    assert {n: t._version for n, t in static["a"].items()} == versions
    held["a"]["w"].add_(1)  # written in place
    held["a"]["c"] = torch.full((2,), 3.0)  # replaced
    assert st.sync("p", held)
    assert static["a"]["w"].tolist() == [1, 2, 3, 4] and static["a"]["c"].tolist() == [3.0, 3.0]
    out = st.hand_out("p")
    assert out["a"]["w"] is not static["a"]["w"] and torch.equal(out["a"]["w"], static["a"]["w"])
    assert st.sync("p", out)
    assert static["a"]["w"]._version == versions["w"] + 1  # the handed-out copy agreed
    for bad in ({"a": {"w": torch.arange(5), "c": torch.ones(2)}},
                {"a": {"w": torch.arange(4)}}, {"b": held["a"]}):
        assert not st.sync("p", bad)
    assert static["a"]["w"].tolist() == [1, 2, 3, 4]


def test_copy_tree_writes_only_other_tensors():
    static = {"a": {"w": torch.zeros(3), "c": torch.zeros(1)}}
    same_c = static["a"]["c"]
    graphs.copy_tree(static, {"a": {"w": torch.ones(3), "c": same_c}})
    assert static["a"]["w"].tolist() == [1.0, 1.0, 1.0] and same_c._version == 0


# --- the step: held tensors, and the graphs' bookkeeping on the CPU ---------------


def test_held_tensors_keep_their_values_across_later_steps():
    m = trainer("speech", "pallas", "cpu")
    data = batches(m, 4, 4)
    states = run(m, data[:1])
    copies = [(o.clone(), tree(g), tree(p)) for o, g, p in states]
    run(m, data[1:])
    assert_same_states(states, copies)


@pytest.mark.parametrize("name,backend,loss,mode",
                         [("person_detect", "pallas", "crossentropy", "quantized"),
                          ("person_detect", "xla", "mse", "quantized"),
                          ("speech", "xla", "crossentropy", "quantized"),
                          ("sine", "pallas", "mse", "float")])
def test_replayed_phases_are_bit_equal_to_eager_steps_on_the_cpu(name, backend, loss, mode,
                                                                  cpu_graphs, monkeypatch):
    m, ref = (trainer(name, backend, "cpu", loss, mode) for _ in range(2))
    eager(ref, monkeypatch)
    data = batches(m, 4, 6)
    before = counters()
    got = run(m, data)
    assert counters()[0] - before[0] == 5 and counters()[1] - before[1] == 1
    steps = trace.records("mft.train.step")[-6:]
    # and, a step, its conv layers by the way their weight gradients were
    # folded: on the CPU all in plain torch
    convs = {trace.WGRAD_PLAIN: 4} if name == "person_detect" else {}
    assert [dict(r.counts) for r in steps] == (
        [{trace.EAGER_STEPS: 1, **convs}] + [{trace.GRAPH_STEPS: 1, **convs}] * 5)
    assert_same_states(got, run(ref, data))
    # nothing a later step did changed what the first steps handed out
    assert_same_states(got, run(trainer(name, backend, "cpu", loss, mode), data))


def edits(model, i: int) -> None:
    """Between steps: the params assigned before step 3, an accumulator at
    the serial fold's edge before step 4 (the step then folds serially,
    eager); the learning rate changes at step 2 (see ``LRS``)."""
    if i == 3:
        p = tree(model.params)
        for sub in p.values():
            if "weights" in sub and sub["weights"].dtype == torch.int8:
                sub["weights"].copy_(sub["weights"] // 2)
        model.params = p
    if i == 4:
        acc = next(v for v in model.grads.values() if v["weights_gradient"].dim() == 4)
        acc["weights_gradient"].fill_(EDGE)


LRS = [LR, LR, 0.05, 0.05, 0.05, 0.05, 0.05]


def test_lr_params_and_the_serial_fold_are_honoured_on_the_cpu(cpu_graphs, monkeypatch):
    m, ref = (trainer("person_detect", "pallas", "cpu") for _ in range(2))
    eager(ref, monkeypatch)
    data = batches(m, 4, 7, seed=1)
    got = run(m, data, LRS, edits)
    kinds = [dict(r.counts) for r in trace.records("mft.train.step")[-7:]]
    want = run(ref, data, LRS, edits)
    assert_same_states(got, want)
    # the edited accumulator went through the serial fold: it clamped, and
    # no entry wrapped to a positive value
    key = next(k for k, v in want[4][1].items() if v["weights_gradient"].dim() == 4)
    assert int((got[4][1][key]["weights_gradient"] > 0).sum()) == 0
    # step 2: a new learning rate (its update eager); 3: its capture, after
    # the params were copied in; 4: the serial fold (its update replays)
    convs = {trace.WGRAD_PLAIN: 4}  # on the CPU the plain path folds every conv
    eager_step, graph_step = {trace.EAGER_STEPS: 1, **convs}, {trace.GRAPH_STEPS: 1, **convs}
    assert kinds == [eager_step, graph_step, eager_step, graph_step, eager_step, graph_step,
                     graph_step]


# --- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the graphs are CUDA graphs)")
    return CUDA


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("loss", ["crossentropy", "mse"])
def test_graph_steps_are_bit_equal_to_eager_steps(cuda, backend, loss, monkeypatch):
    """6 steps of person_detect_trainable(10): one eager, then a capture and
    replays, bit-equal in outputs, grads and params to another model's
    eager steps; the counters read one eager step and five graph steps."""
    m, ref = (trainer("person_detect", backend, cuda, loss) for _ in range(2))
    eager(ref, monkeypatch)
    data = batches(m, 256, 6)
    before = counters()
    got = run(m, data)
    torch.cuda.synchronize(cuda)
    assert (counters()[0] - before[0], counters()[1] - before[1]) == (5, 1)
    assert_same_states(got, run(ref, data))
    assert_same_states(got, run(trainer("person_detect", backend, cuda, loss), data))


@pytest.mark.cuda
def test_lr_params_and_the_serial_fold_are_honoured_on_the_card(cuda, monkeypatch):
    """A learning rate change, a params assignment, and an accumulator at
    -2**31 + 10 (the eager serial fold) between graph steps: bit-equal to
    eager steps."""
    m, ref = (trainer("person_detect", "pallas", cuda) for _ in range(2))
    eager(ref, monkeypatch)
    data = batches(m, 256, 7, seed=1)
    got = run(m, data, LRS, edits)
    assert_same_states(got, run(ref, data, LRS, edits))
    key = next(k for k, v in got[4][1].items() if v["weights_gradient"].dim() == 4)
    assert int((got[4][1][key]["weights_gradient"] > 0).sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,mode", [("speech", "quantized"), ("sine", "float")])
def test_other_models_replay_bit_equal(cuda, name, mode, monkeypatch):
    m, ref = (trainer(name, "pallas", cuda, gradient_mode=mode) for _ in range(2))
    eager(ref, monkeypatch)
    data = batches(m, 256, 4)
    before = counters()
    got = run(m, data)
    assert counters()[0] - before[0] == 3
    assert_same_states(got, run(ref, data))
