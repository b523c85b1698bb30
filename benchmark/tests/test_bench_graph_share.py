"""The reader of ``train.graph_step_share`` on fake records: the share is
taken over the window's steps before the traced slice alone, set-up's
steps are left out, and a program without the counter (the parent of the
change that added it) or without records gives None."""

from collections import Counter

from benchmark import harness
from microflow_tpu_torch.utils import trace

METRIC = "train.graph_step_share"
GRAPH = ("mft.train.graph_steps", 1)
EAGER = ("mft.train.eager_steps", 1)


def steps(kinds: list) -> list:
    return [trace.Record(i, i + 1, None, i, 0, (kind,)) for i, kind in enumerate(kinds)]


def read(recs: list, counters: dict, monkeypatch):
    monkeypatch.setattr(trace, "records",
                        lambda name: list(recs) if name == "mft.train.step" else [])
    return harness.load_reader(METRIC)(harness.Reading(None, counters, None))


def test_the_share_of_the_untraced_window_steps_that_replayed(monkeypatch):
    # 3 checked steps (eager, then captured and replayed), 10 window steps
    # of which one before the slice ran eager and the last 4 were traced
    kinds = [EAGER, GRAPH, GRAPH] + [GRAPH, EAGER, GRAPH, GRAPH, GRAPH, GRAPH] + [EAGER] * 4
    got = read(steps(kinds), {"steps": 10, "steps_traced": 4}, monkeypatch)
    assert got == 100.0 * 5 / 6


def test_every_window_step_replayed(monkeypatch):
    kinds = [EAGER, GRAPH, GRAPH] + [GRAPH] * 10
    assert read(steps(kinds), {"steps": 10, "steps_traced": 4}, monkeypatch) == 100.0


def test_none_without_the_counter_or_the_records(monkeypatch):
    kinds = [EAGER, GRAPH, GRAPH] + [GRAPH] * 10
    counters = {"steps": 10, "steps_traced": 4}
    assert read([], counters, monkeypatch) is None
    assert read(steps(kinds), {}, monkeypatch) is None
    # the parent's program: records without counts, no such counter
    monkeypatch.setattr(trace, "COUNTERS", Counter({trace.HOST_WAITS: 0}))
    parent = [trace.Record(i, i + 1, None, i, 0) for i in range(13)]
    assert read(parent, counters, monkeypatch) is None
