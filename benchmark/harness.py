"""One run of one benchmark cell: set-up, the measured window, the check
against the plain reference, and the result line.

Everything that belongs to one cell is found by name:

* ``workloads/<cell>.json``: the configuration, the driver, the traffic
  parameters and why the cell exists;
* ``configs/<config>.json`` and the model file beside it;
* ``<reference>/model.py``: the configuration's plain reference, in the
  package ``benchmark.<reference>`` that its ``"reference"`` key names
  (``benchmark.reference`` where it names none; see ``reference_of``);
* ``drivers/<driver>.py``: a ``Cell`` class (``setup``, ``window``,
  ``release``, ``check``);
* ``metrics/<metric>.py``: a ``read(reading)`` that returns the per-layer
  metric or None where it finds nothing to read.

``BENCHMARK.json`` at the root of the checkout says which end-to-end and
per-layer metrics each cell reports.  The program under test is
``microflow_tpu_torch``; nothing here imports JAX or the JAX package, and
a run that finds either loaded once the window has closed prints no
result.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

from .trace import Slice

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "microflow_tpu"})
DEFAULT_REFERENCE = "reference"


def load_data(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH, kind, f"{name}.json")) as f:
        return json.load(f)


def reference_name(config: dict) -> str:
    """The package under ``benchmark/`` that holds the plain reference of
    ``config`` (a configuration file's object)."""
    return config.get("reference", DEFAULT_REFERENCE)


def reference_of(config: dict):
    """The ``model`` module of ``config``'s plain reference package,
    ``benchmark.<reference_name(config)>``, laid out like
    ``benchmark/reference/``.  Every site that reads a cell's graph,
    checks its outputs or runs its control goes through it.  The module
    gives:

    * ``parse(path)``: the graph, with ``input_shape``, ``output_shape``
      and ``layers``.  Each layer that the frozen IR classes of
      ``benchmark/reference/compiler/ir.py`` describe is an instance of
      that class, so that ``costs.py`` counts the same MACs and bytes
      whichever package parsed the graph; a layer of any other kind has
      an ``out_shape``, and ``costs.py`` counts it as 0 MACs and 0
      weight bytes;
    * ``Reference(path, device, int4=False)``, whose ``forward(xq)`` runs
      a whole batch (in blocks inside where it must), ``quantize`` and
      ``dequantize``;
    * ``to_int4_grid(weights)``;
    * for train cells, ``Trainer`` and ``optimizer.update_constants_fully_connected``.

    A package that is missing raises ``ModuleNotFoundError`` naming it."""
    return importlib.import_module(find_reference(config))


def find_reference(config: dict) -> str:
    """The name of ``config``'s reference ``model`` module, found without
    importing it (only its package's ``__init__`` runs), so that a run
    fails at set-up on a missing package while the reference's own import
    stays out of ``setup_s``: ``ModuleNotFoundError`` naming it."""
    name = f"benchmark.{reference_name(config)}.model"
    if importlib.util.find_spec(name) is None:
        raise ModuleNotFoundError(f"No module named {name!r}", name=name)
    return name


def spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(benchmark: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics that ``cell`` reports: those
    that list it under ``workloads``, and the end-to-end ones without that
    key (``setup_s``), which every cell reports."""
    e2e = [m for m in benchmark["end_to_end"] if cell in m.get("workloads", [cell])]
    per_layer = [m for m in benchmark["per_layer"] if cell in m["workloads"]]
    return e2e, per_layer


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({n.split(".")[0] for n in sys.modules} & FORBIDDEN)


def load_reader(metric: str):
    """``metrics/<metric>.py``, loaded by its path (a metric's name may
    hold dots)."""
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    spec_ = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module.read


class Window:
    """The measured window.  The driver calls ``open`` just before its
    first timed call, ``running`` before each further one, and ``close``
    once its closing synchronise has returned.  With ``trace_seconds``
    the profiler covers the window's last ``trace_seconds``; ``tracing``
    says whether it is on."""

    def __init__(self, seconds: float, device: torch.device, trace_seconds: float | None):
        self.seconds = seconds
        self.slice = Slice(device) if trace_seconds else None
        self.trace_seconds = min(trace_seconds or 0.0, seconds)
        self.t0 = self.deadline = None
        self.summary = None

    def open(self) -> float:
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + self.seconds
        return self.t0

    @property
    def tracing(self) -> bool:
        return self.slice is not None and self.slice.active

    def running(self) -> bool:
        now = time.perf_counter()
        if (self.slice is not None and not self.slice.active and self.summary is None
                and now >= self.deadline - self.trace_seconds and now < self.deadline):
            self.slice.start()
        return now < self.deadline

    def close(self) -> None:
        if self.slice is not None and self.slice.active:
            self.summary = self.slice.stop()


@dataclass
class Context:
    """What a driver gets: the cell's data, the seed, the device, and the
    places to leave its counters."""

    cell: str
    workload: dict
    config: dict
    params: dict
    seed: int
    device: torch.device
    seconds: float = 0.0  # the window's length, known at set-up
    control: bool = False
    patch: object = None  # called with the program after set-up (tests)
    counters: dict = field(default_factory=dict)
    phases: list = field(default_factory=list)  # (part of set-up, seconds)
    since: float = 0.0  # when the part of set-up under way began

    def phase(self, name: str) -> None:
        """Close the part of set-up named ``name``: it ran since the last."""
        now = time.perf_counter()
        self.phases.append((name, now - self.since))
        self.since = now

    def model_file(self) -> str:
        return os.path.join(BENCH, "configs", self.config["model_file"])

    @property
    def reference(self):
        """The ``model`` module of the configuration's plain reference
        (``reference_of``), imported at its first use: in the check and
        the reading, after ``setup_s`` is taken."""
        return reference_of(self.config)


@dataclass
class Reading:
    """What a per-layer metric's reader gets."""

    trace: object  # trace.TraceSummary or None
    counters: dict
    graph: object  # the configuration's reference's parse of its model


def collector_log(pauses: list):
    """A ``gc.callbacks`` entry that appends ``[start, end, generation]`` of
    each collection to ``pauses``."""
    def log(phase, info):
        if phase == "start":
            pauses.append([time.perf_counter(), None, info["generation"]])
        elif pauses:
            pauses[-1][1] = time.perf_counter()
    return log


def card_power_limit(device: torch.device) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             control: bool = False, patch=None, overrides: dict | None = None) -> dict:
    """One run of ``cell``: returns the result line's object (``checks``
    last), with ``forbidden`` listing any JAX module found loaded."""
    device = torch.device(device)
    workload = load_data("workloads", cell)
    config = load_data("configs", workload["config"])
    find_reference(config)
    ctx = Context(cell, workload, config, {**workload["traffic"], **(overrides or {})}, seed,
                  device, seconds, control, patch)
    driver = importlib.import_module(f"benchmark.drivers.{workload['driver']}")
    program = driver.Cell(ctx)
    ctx.since = t_start
    ctx.phase("imports")
    if device.type == "cuda":
        torch.empty(1, device=device)
        ctx.phase("card")
    program.setup()
    ctx.phase("other")
    print("set-up: " + ", ".join(f"{name} {s:.3f} s" for name, s in ctx.phases),
          file=sys.stderr)
    win = Window(seconds, device, workload["trace_seconds"] if trace else None)
    if win.slice is not None:
        win.slice.prepare()
    # what set-up made (the imports, the program, the inputs) is never
    # scanned by the collector again: a full collection of it pauses every
    # thread of the process for ~0.1 s
    gc.collect()
    gc.freeze()
    pauses: list = []
    gc.callbacks.append(collector_log(pauses))
    try:
        e2e = program.window(win)
        win.close()
    finally:
        gc.callbacks.pop()
        gc.unfreeze()
    done = [b - a for a, b, g in pauses if b is not None]
    print(f"program: backend {ctx.counters.get('backend')}", file=sys.stderr)
    print(f"gc in the window: {len(done)} collections ({sum(g == 2 for _, _, g in pauses)} "
          f"full), longest {max(done, default=0.0) * 1e3:.3f} ms", file=sys.stderr)
    e2e["setup_s"] = win.t0 - t_start
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    program.release()
    checks = program.check()
    benchmark = spec()
    e2e_specs, layer_specs = cell_metrics(benchmark, cell)
    metrics = {}
    if trace:
        reading = Reading(win.summary, ctx.counters, ctx.reference.parse(ctx.model_file()))
        for m in layer_specs:
            value = load_reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e_specs:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    chips = next(w["chips"] for w in benchmark["workloads"] if w["name"] == cell)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": peak,
           "power_limit": card_power_limit(device) if cuda else "none"}
    result = {"correct": all(ok for _, _, _, ok in checks), "attempted": program.attempted,
              "failed": program.failed, "metrics": metrics, "device": dev}
    if trace and win.summary is not None:
        dev["busy_s"] = win.summary.busy_s
        dev["window_s"] = win.summary.window_s
        result["breakdown"] = win.summary.breakdown()
    result["forbidden"] = forbidden_modules()
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit, _ in checks}
    return result


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cells = {w["name"]: w for w in spec()["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has {sorted(cells)}",
              file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start)
    forbidden = result.pop("forbidden")
    if forbidden:
        print(f"forbidden modules loaded in the run's process: {forbidden}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
