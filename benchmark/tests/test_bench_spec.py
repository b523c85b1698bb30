"""BENCHMARK.json and the files it names: they parse, keep to the
contract's limits on names, units and keys, and agree with each other."""

import json
import os
import re

import pytest

from benchmark import harness
from benchmark.costs import activation_bytes_per_inference, macs_per_inference, weight_bytes

ROOT = harness.ROOT
SPEC = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in SPEC["end_to_end"]}
CELLS = {w["name"]: w for w in SPEC["workloads"]}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16 and len(SPEC["command"]) <= 32
    for path in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and ".." not in path
        assert not path.startswith("/") and os.path.isdir(os.path.join(ROOT, path))
    for word in SPEC["command"]:
        assert one_line(word) and not word.startswith("/") and ".." not in word
    named = [w for w in SPEC["command"] if os.path.exists(os.path.join(ROOT, w))]
    assert all(any(w.startswith(p + "/") for p in SPEC["paths"]) for w in named)


def test_names_units_and_entry_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and one_line(w["why"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
    for group in (SPEC["configs"], SPEC["workloads"], SPEC["end_to_end"] + SPEC["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(CELLS)
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e, per_layer = harness.cell_metrics(SPEC, cell)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per_layer


def test_moves_is_an_end_to_end_metric_of_each_of_its_cells():
    for m in SPEC["per_layer"]:
        assert m["moves"] in E2E
        for cell in m["workloads"]:
            assert cell in CELLS
            reported = {e["name"] for e in harness.cell_metrics(SPEC, cell)[0]}
            assert m["moves"] in reported, (m["name"], cell)


def test_layers_are_named_as_perf_md_lists_them():
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for m in SPEC["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


WORKLOAD_FILES = sorted(f[:-len(".json")]
                        for f in os.listdir(os.path.join(harness.BENCH, "workloads")))


def test_every_cell_has_a_workload_file():
    assert CELLS.keys() <= set(WORKLOAD_FILES)


@pytest.mark.parametrize("cell", WORKLOAD_FILES)
def test_workload_file_parses_and_matches(cell):
    w = harness.load_data("workloads", cell)
    assert NAME.match(cell) and one_line(w["why"])
    if cell in CELLS:
        assert w["config"] == CELLS[cell]["config"] and w["why"] == CELLS[cell]["why"]
    assert os.path.exists(os.path.join(harness.BENCH, "drivers", f"{w['driver']}.py"))
    assert w["trace_seconds"] > 0 and isinstance(w["traffic"], dict)


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_file_parses_and_states_the_graph(config):
    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    with open(os.path.join(ROOT, entry["file"])) as f:
        c = json.load(f)
    assert c["name"] == config and c["source"] == entry["source"]
    assert c["reduced"] == entry["reduced"]
    g = harness.reference_of(c).parse(os.path.join(harness.BENCH, "configs", c["model_file"]))
    assert list(g.input_shape) == c["input_shape"] and list(g.output_shape) == c["output_shape"]
    assert len(g.layers) == c["operators"]
    assert macs_per_inference(g) == c["macs_per_inference"]
    assert activation_bytes_per_inference(g) == c["activation_bytes_per_inference"]
    assert weight_bytes(g) == c["weight_bytes"]
    assert any(w["config"] == config for w in SPEC["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_loads_and_reads_nothing_from_an_empty_run(metric):
    read = harness.load_reader(metric)
    assert read(harness.Reading(None, {}, None)) is None
