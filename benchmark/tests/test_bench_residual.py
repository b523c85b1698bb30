"""The residual graph's cell (``mobilenet_v2.score``) on the CPU: its
per-layer readers on synthetic readings, the bytes its ``ADD``s move
counted by hand, and one small run of the cell, of its control and of its
planted faults through the harness (batches of 2 rows)."""

import time
import types

import pytest

from benchmark import harness
from benchmark.faults import FAULTS
from benchmark.metrics._residual import add_bytes_per_inference
from benchmark.reference_residual.model import parse
from microflow_tpu_torch.models import synth
from microflow_tpu_torch.utils import trace

CELL = "mobilenet_v2.score"
MOBILENET = f"{harness.BENCH}/configs/mobilenet_v2.tflite"
SMALL = {"batch": 2, "pool_batches": 2}
NEW = ("add_roofline.score", "perop.kernel_ms_per_call", "perop.glue_ms_per_call",
       "perop.add_host_us_per_call", "perop.live_peak_mb")
# a traced slice of 4 calls: device seconds by operation
OPS = {"void qgemm_mma<4>(...)": 0.030, "qgemm_rows<2>": 0.004, "qdwconv_tile": 0.010,
       "qadd_kernel": 0.0016, "at::native::im2col elementwise": 0.004,
       "Memcpy DtoD (Device -> Device)": 0.0004, "Memset (Device)": 0.0001}


@pytest.fixture(scope="module")
def residual_graph(tmp_path_factory):
    path = synth.write(str(tmp_path_factory.mktemp("res") / "residual.tflite"), synth.residual())
    return parse(path)


def test_add_bytes_match_a_hand_count(residual_graph):
    # two ADDs, 8x8x8 and 4x4x16: two int8 inputs read and one output
    # written an element
    assert add_bytes_per_inference(residual_graph) == 3 * (8 * 8 * 8 + 4 * 4 * 16) == 2304
    # MobileNetV2's ten: 56x56x24 once, 28x28x32 twice, 14x14x64 three
    # times, 14x14x96 and 7x7x160 twice each
    elems = 56 * 56 * 24 + 2 * 28 * 28 * 32 + 3 * 14 * 14 * 64 + 2 * 14 * 14 * 96 + 2 * 7 * 7 * 160
    assert add_bytes_per_inference(parse(MOBILENET)) == 3 * elems == 649152


def synthetic_reading(graph, monkeypatch) -> harness.Reading:
    """10 calls of 1024 rows, the last 4 traced; the 6 before each issued
    two ADDs of 30 and 20 us; the walk's peak 1,540,000,000 bytes."""
    slice_ = types.SimpleNamespace(
        window_s=0.08, busy_s=0.078,
        device_seconds=lambda match: sum(s for n, s in OPS.items() if match(n)))
    recs = {"mft.predict": [trace.Record(0, 9_000_000, None, i, 0) for i in range(12)],
            "mft.op.add": [trace.Record(0, d, "mft.predict", i, 0)
                           for i in range(12) for d in (30_000, 20_000)]}
    monkeypatch.setattr(trace, "records", lambda name: list(recs.get(name, [])))
    monkeypatch.setitem(trace.COUNTERS, trace.LIVE_PEAK, 1_540_000_000)
    counters = {"calls": 10, "calls_traced": 4, "batch": 1024, "host_us_per_call": 2000.0}
    return harness.Reading(slice_, counters, graph)


@pytest.mark.parametrize("metric,want", [
    ("add_roofline.score", 100.0 * 2304 * 1024 * 4 / 3.35e12 / 0.0016),
    ("perop.kernel_ms_per_call", 1e3 * 0.044 / 4),
    ("perop.glue_ms_per_call", 1e3 * 0.0045 / 4),
    ("perop.add_host_us_per_call", 50.0),
    ("perop.live_peak_mb", 1540.0),
])
def test_each_new_reader_reads_a_synthetic_reading(residual_graph, monkeypatch, metric, want):
    read = harness.load_reader(metric)
    assert read(synthetic_reading(residual_graph, monkeypatch)) == pytest.approx(want, rel=1e-12)
    assert read(harness.Reading(None, {}, None)) is None


def test_the_new_metrics_list_only_the_new_cell():
    spec = {m["name"]: m for m in harness.spec()["per_layer"]}
    for name in NEW:
        assert spec[name]["workloads"] == [CELL] and spec[name]["moves"] == "score_inferences_per_s"


def run(**kw) -> dict:
    return harness.run_cell(CELL, 2**31 + 77, 0.2, kw.pop("traced", False), "cpu",
                            time.perf_counter(), overrides=SMALL, **kw)


def test_the_cell_runs_and_is_right_on_the_cpu():
    r = run(traced=True)
    assert r["correct"] and r["forbidden"] == [], r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values()), r["checks"]
    # the program's own span and counter read off the CPU too; the profiler
    # records no device work here, so the device's metrics stay out
    assert r["metrics"]["perop.add_host_us_per_call"]["value"] > 0
    assert r["metrics"]["perop.live_peak_mb"]["value"] > 0
    assert "add_roofline.score" not in r["metrics"]


def test_the_control_is_not_correct_on_the_cpu():
    r = run(control=True)
    assert not r["correct"] and r["checks"]["outputs_wrong"]["value"] > 0, r["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS["score"]))
def test_each_planted_fault_is_caught_on_the_cpu(fault):
    r = run(patch=FAULTS["score"][fault])
    assert not r["correct"], (fault, r["checks"])
