"""The check that decides ``correct``, with the timed path broken
underneath: a run on the CPU at a small size, the harness's look for a
card skipped, comes out not correct for each fault the cell can have,
and for the control (the int4 reference in the program's place)."""

import time

import pytest

from benchmark import harness
from benchmark.faults import FAULTS
from benchmark.harness import load_data, run_cell

# the serve case checks every request it sends: the altered answer is one
# row of each dispatched batch, which a sample could miss
SMALL = {
    "person_detect.score": {"batch": 4, "pool_batches": 2},
    "speech.score": {"batch": 8, "pool_batches": 2},
    "person_detect.serve": {"rate_rps": 16, "max_rows": 40, "big_rows": 48, "big_every": 3,
                            "pool_rows": 64, "submitters": 4, "check_requests": 64,
                            "check_big": 2, "warm_s": 0.2},
    "person_detect.train": {"batch": 4, "pool_batches": 4},
}
DRIVER = {c: load_data("workloads", c)["driver"] for c in SMALL}
SECONDS = {"person_detect.score": 0.3, "speech.score": 0.3, "person_detect.serve": 0.5,
           "person_detect.train": 0.3}


@pytest.fixture(autouse=True)
def every_driver_has_a_cell(monkeypatch):
    """``person_detect.serve`` is a workload of ``serve_sweep.py`` that no
    cell of BENCHMARK.json names yet; its driver's check runs here as a
    cell's would."""
    spec = harness.spec()
    named = {w["name"] for w in spec["workloads"]}
    for cell in SMALL.keys() - named:
        w = load_data("workloads", cell)
        spec["workloads"].append({"name": cell, "config": w["config"], "traffic": cell,
                                  "chips": 1, "why": w["why"]})
    monkeypatch.setattr(harness, "spec", lambda: spec)


def run(cell, patch=None, control=False, seed=2**31 + 77):
    return run_cell(cell, seed, SECONDS[cell], False, "cpu", time.perf_counter(),
                    control=control, patch=patch, overrides=SMALL[cell])


def bad(result) -> set:
    return {k for k, c in result["checks"].items() if c["value"] != c["limit"]}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"] and not bad(r), r["checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(cell):
    r = run(cell, control=True)
    assert not r["correct"] and bad(r) - {"golden_diff"}, r["checks"]


CAUGHT = {
    ("score", "answer_altered"): {"outputs_wrong", "max_abs_diff"},
    ("score", "half_batch"): {"outputs_wrong", "max_abs_diff"},
    ("serve", "answer_altered"): {"rows_wrong", "max_abs_diff"},
    ("serve", "half_batch"): {"rows_wrong", "max_abs_diff"},
    ("train", "state_unchanged"): {"change_gap", "last_step_entries_wrong"},
    ("train", "half_batch"): {"grad_gap", "change_gap", "loss_gap", "last_step_entries_wrong"},
    ("train", "answer_altered"): {"grad_gap", "state_entries_wrong", "last_step_entries_wrong"},
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(SMALL)
                                        for f in FAULTS[DRIVER[c]]])
def test_fault_is_caught(cell, fault):
    r = run(cell, patch=FAULTS[DRIVER[cell]][fault])
    assert not r["correct"] and CAUGHT[DRIVER[cell], fault] <= bad(r), r["checks"]
    if fault == "state_unchanged":
        assert r["checks"]["change_gap"]["value"] == 1.0


def test_a_fault_that_starts_in_the_window_is_caught():
    """Set-up's checked steps pass; from the window's first step on, the
    update leaves the state as it was.  Only the check of the window's last
    step can see it."""
    checked = load_data("workloads", "person_detect.train")["traffic"]["checked_steps"]

    def later_unchanged(model):
        update, calls = model.update_layers, [0]

        def broken(batch_size, lr):
            calls[0] += 1
            if calls[0] <= checked:
                update(batch_size, lr)
        model.update_layers = broken

    r = run("person_detect.train", patch=later_unchanged)
    assert not r["correct"] and bad(r) == {"last_step_entries_wrong"}, r["checks"]
