"""The port's spans and counters (``microflow_tpu_torch/utils/trace.py``):
what a train step and a ``predict_inner`` call record, the buffer's cap,
the profiler's view of the spans, and the counting helpers of
``core/numerics.py``.  CPU tests, but for one ``cuda``-marked test that
holds ``mft.host_waits`` to the profiler's count of pageable copies on the
card.  This file imports neither JAX nor ``microflow_tpu``."""

import gc
from collections import OrderedDict

import numpy as np
import pytest
import torch

from microflow_tpu_torch import kernels
from microflow_tpu_torch.core import numerics
from microflow_tpu_torch.models import person_detect_trainable, speech, speech_trainable
from microflow_tpu_torch.utils import trace

STEP = "mft.train.step"
PHASES = ("mft.train.forward", "mft.train.backward", "mft.train.update")


def batch(model, n: int, seed: int = 0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-128, 128, (n, *model.graph.input_shape), dtype=torch.int8, generator=gen)
    gt = torch.full((n, *model.graph.output_shape), -128, dtype=torch.int8)
    gt[:, 0] = 127
    return x.to(device), gt.to(device)


def step(model, x, gt) -> int:
    """One train step and its update; the step's identifier."""
    model.predict_quantized_train(x, gt)
    model.update_layers(x.shape[0], 0.01)
    return trace.records(STEP)[-1].ident


def of_step(name: str, ident: int) -> list:
    return [r for r in trace.records(name) if r.ident == ident]


def self_ns(name: str, ident: int, children: list) -> int:
    """The span's duration less what its children (disjoint, in it) cover."""
    (rec,) = [r for r in of_step(name, ident) if r.parent != name]
    covered = sum(r.end - r.start for c in children for r in of_step(c, ident)
                  if r.parent == name)
    return rec.end - rec.start - covered


def test_a_speech_step_records_one_step_span_and_its_children():
    m = speech_trainable(device="cpu")
    x, gt = batch(m, 4)
    ident = step(m, x, gt)
    (root,) = of_step(STEP, ident)
    assert root.parent is None
    for name, parent in [("mft.train.forward", STEP), ("mft.train.backward", STEP),
                         ("mft.train.update", STEP), ("mft.train.fold", STEP),
                         ("mft.train.backward.fc", "mft.train.backward")]:
        (rec,) = of_step(name, ident)
        assert rec.parent == parent, name
        assert root.start <= rec.start <= rec.end <= root.end, name
    # the next step takes the next identifier
    assert step(m, x, gt) == ident + 1


def test_a_step_without_its_update_nests_nothing_and_ends_at_the_next_step():
    m = speech_trainable(device="cpu")
    x, gt = batch(m, 2)
    m.predict_quantized_train(x, gt)
    with trace.Span("test.between") as between:
        pass
    assert between.parent is None
    m.predict_quantized_train(x, gt)  # the first step ends here, without an update
    first, second = trace.records(STEP)[-1].ident, m._step.ident
    assert second == first + 1 and not of_step("mft.train.update", first)
    m.update_layers(2, 0.01)
    (update,) = of_step("mft.train.update", second)
    assert update.parent == STEP and of_step(STEP, second)


def test_person_detect_backward_spans_by_layer_type_and_the_fold():
    m = person_detect_trainable(10, backend="pallas", device="cpu")
    x, gt = batch(m, 2)
    ident = step(m, x, gt)
    kinds = {"mft.train.backward.conv": 4, "mft.train.backward.dwconv": 3,
             "mft.train.backward.pool": 1}
    for name, n in kinds.items():
        recs = of_step(name, ident)
        assert len(recs) == n and {r.parent for r in recs} == {"mft.train.backward"}, name
    # the bound read, under the step, and one fold a conv or depthwise layer
    folds = of_step("mft.train.fold", ident)
    assert sorted(r.parent for r in folds) == sorted(
        [STEP] + ["mft.train.backward.conv"] * 4 + ["mft.train.backward.dwconv"] * 3)


def test_the_train_spans_cover_the_step():
    m = person_detect_trainable(10, backend="pallas", device="cpu")
    x, gt = batch(m, 2)
    step(m, x, gt)
    shares = []
    gc.disable()
    try:
        for _ in range(3):
            ident = step(m, x, gt)
            (root,) = of_step(STEP, ident)
            shares.append(self_ns(STEP, ident, list(PHASES) + ["mft.train.fold"])
                          / (root.end - root.start))
            back = self_ns("mft.train.backward", ident,
                           ["mft.train.backward.conv", "mft.train.backward.dwconv",
                            "mft.train.backward.pool", "mft.train.backward.fc"])
            assert back >= 0
    finally:
        gc.enable()
    assert 0 <= np.median(shares) < 0.1, shares


def test_predict_inner_records_one_predict_span_a_call():
    m = speech(device="cpu")
    x = torch.zeros((3, *m.graph.input_shape), dtype=torch.int8)
    m.predict_inner(x)
    first = trace.records("mft.predict")[-1].ident
    for _ in range(3):
        m.predict_inner(x)
    recs = trace.records("mft.predict")
    assert [r.ident for r in recs[-4:]] == list(range(first, first + 4))
    assert all(r.parent is None and r.waits == 0 for r in recs[-4:])


def test_the_buffer_keeps_the_newest_cap_records():
    name = "test.cap"
    for _ in range(trace.CAP + 10):
        with trace.Span(name):
            pass
    recs = trace.records(name)
    assert len(recs) == trace.CAP
    assert recs[0].ident == recs[-1].ident - trace.CAP + 1
    assert trace.snapshot()["spans"][name]["count"] >= trace.CAP + 10


def test_no_profiler_no_record_function(monkeypatch):
    entered = []

    class Fake:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(trace, "record_function", Fake)
    m = speech_trainable(device="cpu")
    x, gt = batch(m, 2)
    step(m, x, gt)
    m.predict_inner(x)
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(m, x, gt)
    assert STEP in entered and "mft.train.update" in entered


def test_the_profiler_shows_the_spans_nested_as_recorded():
    m = speech_trainable(device="cpu")
    x, gt = batch(m, 2)
    step(m, x, gt)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ident = step(m, x, gt)
    events = {}
    for ev in prof.events():
        if ev.name.startswith("mft."):
            # function scope, as operators: the profiler copies a user-scope
            # range onto the device's timeline, where it would read as work
            assert ev.scope == torch._C._profiler.RecordScope.FUNCTION.value, ev.name
            events.setdefault(ev.name, []).append((ev.time_range.start, ev.time_range.end))
    names = [STEP, *PHASES, "mft.train.fold", "mft.train.backward.fc"]
    assert set(names) <= set(events)
    for name in names[1:]:
        (parent,) = {r.parent for r in of_step(name, ident)}
        for start, end in events[name]:
            assert any(ps <= start and end <= pe for ps, pe in events[parent]), name


def test_launches_is_the_trace_modules_counter():
    assert kernels.LAUNCHES is trace.LAUNCHES
    assert "LAUNCHES" in kernels.__all__


def waits() -> int:
    return trace.COUNTERS[trace.HOST_WAITS]


def test_the_helpers_return_what_the_old_calls_returned_and_count_only_off_the_cpu():
    vec = np.array([1, -2, 3], np.int32)
    before = waits()
    assert torch.equal(numerics.const_f32(0.1, "cpu"),
                       torch.as_tensor(np.asarray(0.1, np.float32), device="cpu"))
    got = numerics.as_device(vec, torch.device("cpu"), torch.int64)
    assert got.dtype == torch.int64 and torch.equal(got, torch.as_tensor(vec, dtype=torch.int64))
    assert numerics.as_device(vec, "cpu").dtype == torch.int32
    assert int(numerics.read_host(torch.tensor(7))) == int(torch.tensor(7))
    assert waits() == before
    # the meta device stands for a card: shapes and dtypes, no data
    meta = torch.device("meta")
    for got, want in [(numerics.const_f32([0.5, 2.0], meta),
                       torch.as_tensor(np.asarray([0.5, 2.0], np.float32), device=meta)),
                      (numerics.const_f32(torch.tensor(3), "meta"),
                       torch.tensor(3).to(device=meta, dtype=torch.float32)),
                      (numerics.as_device(vec, meta), torch.as_tensor(vec, device=meta)),
                      (numerics.as_device([1, 2], "meta:0", torch.int32),
                       torch.as_tensor([1, 2], dtype=torch.int32, device=meta))]:
        assert got.device.type == "meta" and got.dtype == want.dtype and got.shape == want.shape
    assert waits() == before + 4
    # a value already on the card crosses nothing
    on_card = torch.empty(3, device=meta)
    numerics.const_f32(on_card, meta)
    numerics.as_device(on_card, meta)
    assert waits() == before + 4

    class OnCard:
        device = meta

        def cpu(self):
            return torch.tensor(5)

    assert int(numerics.read_host(OnCard())) == 5
    assert waits() == before + 5


def test_snapshot_gives_each_span_and_the_counters():
    with trace.Span("test.snapshot", root=True):
        with trace.Span("test.snapshot.child"):
            pass
    snap = trace.snapshot()
    for name in ("test.snapshot", "test.snapshot.child"):
        entry = snap["spans"][name]
        assert entry["count"] >= 1 and entry["p50_ms"] >= 0 and entry["total_ms"] >= 0
    assert trace.HOST_WAITS in snap["counters"]
    assert snap["launches"] == dict(kernels.LAUNCHES)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the copies to count are the card's)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_host_waits_equal_the_profilers_pageable_copies_of_a_step(cuda, monkeypatch):
    """The first step makes the step's resident constants: its waits are the
    profiler's pageable copies.  A later step (replayed as CUDA graphs)
    copies nothing from the host and counts no wait."""
    from torch.profiler import ProfilerActivity, profile

    def profiled_step():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ident = step(m, x, gt)
            torch.cuda.synchronize(cuda)
        (root,) = of_step(STEP, ident)
        device = [ev.name for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        # the spans stay on the host's timeline
        assert not [n for n in device if n.startswith("mft.")]
        return root, [n for n in device if n.startswith("Memcpy") and "Pageable" in n]

    # no constant resident yet, whatever ran before in this process
    monkeypatch.setattr(numerics, "_resident", OrderedDict())
    m = person_detect_trainable(10, backend="pallas", device=cuda)
    x, gt = batch(m, 256, device=cuda)
    m.warm(256)  # builds the kernels
    torch.cuda.synchronize(cuda)
    root, copies = profiled_step()
    assert root.waits == len(copies) > 0, sorted(set(copies))
    step(m, x, gt)  # the capture
    root, copies = profiled_step()
    assert root.waits == len(copies) == 0, sorted(set(copies))
    assert dict(root.counts) == {trace.GRAPH_STEPS: 1, trace.WGRAD_FOLDS: 4}
