"""The readers of the program's own spans and counter
(``metrics/_spans.py`` and the five metrics that use it), on a fake
reading and fake records: the median is taken over the window's steps or
calls before the traced slice alone, set-up's records are left out, and
a run that recorded nothing gives None."""

import pytest

from benchmark import harness
from microflow_tpu_torch.utils import trace

MS = 1_000_000  # ns
TRAIN = ("train.forward_host_ms_per_step", "train.backward_host_ms_per_step",
         "train.update_host_ms_per_step", "train.host_waits_per_step")
LAUNCH = "launch_host_us_per_call.score"


def train_records(setup: int, window: int) -> dict:
    """Records of ``setup`` checked steps, then ``window`` window steps.
    Step i's forward takes i ms, its backward 2i, its update 3i, and it
    counts i waits; set-up's take 1000 ms each, so that any set-up record
    in the median would show."""
    recs = {n: [] for n in ("mft.train.step", "mft.train.forward", "mft.train.backward",
                            "mft.train.update", "mft.train.fold")}
    for i in range(setup + window):
        k = 1000 if i < setup else i
        t = i * 10_000 * MS
        recs["mft.train.forward"].append(trace.Record(t, t + k * MS, "mft.train.step", i, 0))
        recs["mft.train.backward"].append(trace.Record(t, t + 2 * k * MS, "mft.train.step", i, 0))
        recs["mft.train.update"].append(trace.Record(t, t + 3 * k * MS, "mft.train.step", i, 0))
        # a fold under the backward shares the step's identifier, not its parent
        recs["mft.train.fold"].append(trace.Record(t, t + MS, "mft.train.backward.conv", i, 0))
        recs["mft.train.step"].append(trace.Record(t, t + 7 * k * MS, None, i, k))
    return recs


def read(metric: str, recs: dict, counters: dict, monkeypatch):
    monkeypatch.setattr(trace, "records", lambda name: list(recs.get(name, [])))
    return harness.load_reader(metric)(harness.Reading(None, counters, None))


@pytest.mark.parametrize("metric,scale", zip(TRAIN, (1, 2, 3, 1)))
def test_train_readers_take_the_median_of_the_untraced_window_steps(metric, scale, monkeypatch):
    # 3 checked steps (identifiers 0-2), then 10 window steps (3-12) of
    # which the last 4 (9-12) ran under the profiler: the median is over
    # steps 3-8
    recs = train_records(3, 10)
    got = read(metric, recs, {"steps": 10, "steps_traced": 4}, monkeypatch)
    assert got == pytest.approx(scale * 5.5)


def test_train_readers_leave_out_set_up_when_nothing_was_traced(monkeypatch):
    recs = train_records(3, 4)
    got = read("train.forward_host_ms_per_step", recs, {"steps": 4, "steps_traced": 0},
               monkeypatch)
    assert got == pytest.approx(4.5)


def test_the_buffer_may_have_dropped_the_oldest_window_steps(monkeypatch):
    recs = {n: r[8:] for n, r in train_records(3, 10).items()}  # steps 8-12 kept
    got = read("train.update_host_ms_per_step", recs, {"steps": 10, "steps_traced": 4},
               monkeypatch)
    assert got == pytest.approx(3 * 8)


def test_launch_reader_reads_the_launches_under_predict_in_the_untraced_calls(monkeypatch):
    recs = {"mft.predict": [], "mft.flat.launch": []}
    for i in range(2 + 6):  # the golden and the warm-up, then 6 calls, 2 traced
        us = 10_000 if i < 2 else 100 + i
        recs["mft.predict"].append(trace.Record(0, (us + 50) * 1000, None, i, 0))
        recs["mft.flat.launch"].append(trace.Record(0, us * 1000, "mft.predict", i, 0))
    # a launch of the kernel called outside predict_inner is no call's
    recs["mft.flat.launch"].append(trace.Record(0, 10 ** 9, None, 5, 0))
    got = read(LAUNCH, recs, {"calls": 6, "calls_traced": 2}, monkeypatch)
    assert got == pytest.approx(103.5)


@pytest.mark.parametrize("metric", TRAIN + (LAUNCH,))
def test_readers_give_none_where_nothing_was_recorded(metric, monkeypatch):
    counters = {"steps": 10, "steps_traced": 4, "calls": 6, "calls_traced": 2}
    assert read(metric, {}, counters, monkeypatch) is None
    assert read(metric, {}, {}, monkeypatch) is None
    # every window step or call traced: none before the slice
    full = {"steps": 10, "steps_traced": 10, "calls": 6, "calls_traced": 6}
    recs = {**train_records(3, 10), "mft.predict": [
        trace.Record(0, 1000, None, i, 0) for i in range(8)]}
    assert read(metric, recs, full, monkeypatch) is None


def test_readers_give_none_without_the_trace_module(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_trace(name, *args, **kwargs):
        if name == "microflow_tpu_torch.utils" and "trace" in (args[2] if len(args) > 2
                                                                 else kwargs.get("fromlist") or ()):
            raise ImportError("no trace module (the parent commit)")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    counters = {"steps": 10, "steps_traced": 4, "calls": 6, "calls_traced": 2}
    for metric in TRAIN + (LAUNCH,):
        assert harness.load_reader(metric)(harness.Reading(None, counters, None)) is None
