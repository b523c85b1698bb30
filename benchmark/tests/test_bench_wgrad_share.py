"""The reader of ``train.wgrad_fold_share`` on fake records: the share is
taken over the window's steps before the traced slice alone, and a
program without the counters (the parent of the change that added them),
without records, or whose steps folded no conv layer gives None."""

from collections import Counter

from benchmark import harness
from microflow_tpu_torch.utils import trace

METRIC = "train.wgrad_fold_share"
FOLDS, PLAIN = "mft.train.wgrad_folds", "mft.train.wgrad_plain"


def steps(counts: list) -> list:
    return [trace.Record(i, i + 1, None, i, 0, tuple(c.items())) for i, c in enumerate(counts)]


def read(recs: list, counters: dict, monkeypatch):
    monkeypatch.setattr(trace, "records",
                        lambda name: list(recs) if name == "mft.train.step" else [])
    return harness.load_reader(METRIC)(harness.Reading(None, counters, None))


def test_the_kernels_share_of_the_untraced_window_steps(monkeypatch):
    # 3 checked steps, 10 window steps: one before the slice folded 1 of
    # its 4 convs through the kernel, the last 4 were traced
    kernel, plain = {FOLDS: 4}, {PLAIN: 4}
    counts = [plain] * 3 + [kernel] * 5 + [{FOLDS: 1, PLAIN: 3}] + [plain] * 4
    got = read(steps(counts), {"steps": 10, "steps_traced": 4}, monkeypatch)
    assert got == 100.0 * 21 / 24


def test_every_window_step_on_the_kernel(monkeypatch):
    counts = [{PLAIN: 4}] * 3 + [{FOLDS: 4}] * 10
    assert read(steps(counts), {"steps": 10, "steps_traced": 4}, monkeypatch) == 100.0


def test_none_without_the_counters_the_records_or_a_conv(monkeypatch):
    counters = {"steps": 10, "steps_traced": 4}
    assert read([], counters, monkeypatch) is None
    assert read(steps([{FOLDS: 4}] * 13), {}, monkeypatch) is None
    assert read(steps([{}] * 13), counters, monkeypatch) is None  # no conv layer
    # the parent's program: records without counts, no such counter
    monkeypatch.setattr(trace, "COUNTERS", Counter({trace.HOST_WAITS: 0}))
    parent = [trace.Record(i, i + 1, None, i, 0) for i in range(13)]
    assert read(parent, counters, monkeypatch) is None
