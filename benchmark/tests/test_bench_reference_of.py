"""Each configuration finds its plain reference by its ``"reference"`` key
(``harness.reference_of``).  Every configuration of BENCHMARK.json takes
the frozen ``benchmark/reference/``.  A stub package that a configuration
names carries a cell's graph, check and control in its place, and a graph
with a layer of a kind the frozen IR lacks still gives every per-layer
reader of the score cells its number, with the same MACs."""

import importlib.machinery
import sys
import time
import types
from dataclasses import dataclass

import pytest

import benchmark.reference.model as frozen
from benchmark import harness
from benchmark.costs import macs_per_inference
from benchmark.drivers import score
from microflow_tpu_torch.utils import trace

SPEC = harness.spec()
STUB = "stub_reference"
CELL, CONFIG = "speech.score", "speech"
SMALL = {"batch": 8, "pool_batches": 2}


@dataclass
class ExtraLayer:
    """A layer of a kind the frozen IR lacks: it has only an ``out_shape``."""

    index: int
    out_shape: tuple


def stub_model(extra_layer: bool = False):
    """The ``model`` module of a package ``benchmark.stub_reference`` that
    wraps the frozen reference, and the calls it counts: ``parse``, each
    ``Reference`` made (its ``int4``), and each ``forward``.  With
    ``extra_layer`` its graph ends in an ``ExtraLayer``."""
    calls = {"parse": 0, "Reference": [], "forward": 0}

    def parse(path):
        calls["parse"] += 1
        graph = frozen.parse(path)
        if extra_layer:
            graph.layers.append(ExtraLayer(len(graph.layers), tuple(graph.output_shape)))
        return graph

    class Reference(frozen.Reference):
        def __init__(self, path, device, int4=False):
            calls["Reference"].append(int4)
            super().__init__(path, device, int4=int4)

        def forward(self, xq, block=1024):
            calls["forward"] += 1
            return super().forward(xq, block)

    model = types.ModuleType(f"benchmark.{STUB}.model")
    model.__spec__ = importlib.machinery.ModuleSpec(model.__name__, None)
    model.parse, model.Reference = parse, Reference
    model.to_int4_grid, model.Trainer, model.optimizer = (frozen.to_int4_grid, frozen.Trainer,
                                                          frozen.optimizer)
    return model, calls


def name_reference(monkeypatch, reference: str, model=None) -> None:
    """Give speech's configuration the key ``"reference": reference``, and
    put ``model`` in place as that package's module."""
    if model is not None:
        package = types.ModuleType(f"benchmark.{reference}")
        package.model = model
        monkeypatch.setitem(sys.modules, package.__name__, package)
        monkeypatch.setitem(sys.modules, model.__name__, model)
    load = harness.load_data

    def load_data(kind, name):
        data = load(kind, name)
        return {**data, "reference": reference} if (kind, name) == ("configs", CONFIG) else data

    monkeypatch.setattr(harness, "load_data", load_data)


def run(control: bool = False) -> dict:
    return harness.run_cell(CELL, 2**31 + 41, 0.2, True, "cpu", time.perf_counter(),
                            control=control, overrides=SMALL)


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_every_configuration_takes_the_frozen_reference(config):
    assert harness.reference_of(harness.load_data("configs", config)) is frozen


def test_a_named_reference_carries_the_graph_and_the_check(monkeypatch):
    default = run()
    model, calls = stub_model()
    name_reference(monkeypatch, STUB, model)
    stubbed = run()
    # the reading's graph, one reference for the check, a forward a pool batch
    assert calls == {"parse": 1, "Reference": [False], "forward": SMALL["pool_batches"]}
    assert stubbed["correct"] is default["correct"] is True
    assert stubbed["checks"] == default["checks"]


def test_the_control_runs_on_the_named_reference(monkeypatch):
    model, calls = stub_model()
    name_reference(monkeypatch, STUB, model)
    r = run(control=True)
    assert calls["Reference"] == [False, True] and not r["correct"], r["checks"]


def test_a_missing_reference_package_fails_at_set_up_with_its_name(monkeypatch):
    built = []
    monkeypatch.setattr(score.Cell, "setup", lambda self: built.append(self))
    name_reference(monkeypatch, "no_such_reference")
    with pytest.raises(ModuleNotFoundError, match="benchmark.no_such_reference"):
        run()
    assert not built


def test_the_reference_is_imported_after_set_up_and_the_window(monkeypatch):
    """Set-up only looks the package up: the reference's own import falls
    in the check, after ``setup_s`` is taken and the window has closed."""
    import benchmark.reference

    name, seen = frozen.__name__, {}
    setup, window = score.Cell.setup, score.Cell.window

    def spy_setup(self):
        setup(self)
        seen["setup"] = name in sys.modules

    def spy_window(self, win):
        out = window(self, win)
        seen["window"] = name in sys.modules
        return out

    monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(benchmark.reference, "model", frozen)
    monkeypatch.setattr(score.Cell, "setup", spy_setup)
    monkeypatch.setattr(score.Cell, "window", spy_window)
    r = run()
    assert seen == {"setup": False, "window": False}
    assert name in sys.modules and r["correct"], r["checks"]


def score_metrics() -> list[str]:
    cells = {w["name"] for w in SPEC["workloads"]
             if harness.load_data("workloads", w["name"])["driver"] == "score"}
    return [m["name"] for m in SPEC["per_layer"] if cells & set(m["workloads"])]


def test_a_layer_kind_the_frozen_ir_lacks_counts_no_macs_and_every_reader_reads(monkeypatch):
    path = f"{harness.BENCH}/configs/{harness.load_data('configs', CONFIG)['model_file']}"
    model, _ = stub_model(extra_layer=True)
    graph, plain = model.parse(path), frozen.parse(path)
    assert isinstance(graph.layers[-1], ExtraLayer) and len(graph.layers) == len(plain.layers) + 1
    assert macs_per_inference(graph) == macs_per_inference(plain) > 0
    # a traced slice of 4 calls of 8192 rows, 0.8 ms of kernels each, after
    # 6 untraced calls whose launches took 70 us
    slice_ = types.SimpleNamespace(window_s=0.004, busy_s=0.0035,
                                   device_seconds=lambda match: 0.0032)
    counters = {"calls": 10, "calls_traced": 4, "batch": 8192, "host_us_per_call": 200.0}
    recs = {"mft.predict": [trace.Record(0, 90_000, None, i, 0) for i in range(12)],
            "mft.flat.launch": [trace.Record(0, 70_000, "mft.predict", i, 0) for i in range(12)]}
    monkeypatch.setattr(trace, "records", lambda name: list(recs.get(name, [])))
    metrics = score_metrics()
    assert metrics
    for metric in metrics:
        read = harness.load_reader(metric)
        value = read(harness.Reading(slice_, counters, graph))
        assert isinstance(value, float) and value > 0, metric
        assert value == read(harness.Reading(slice_, counters, plain)), metric
