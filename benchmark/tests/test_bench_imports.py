"""Nothing the benchmark runs imports JAX or the JAX package, by top-level
name compared whole; no reference package (``benchmark/reference/`` and
each one a configuration names) imports anything of the program either."""

import ast
import os
import subprocess
import sys

from benchmark.harness import (BENCH, DEFAULT_REFERENCE, FORBIDDEN, ROOT, load_data,
                               reference_name, spec)

PROGRAM = "microflow_tpu_torch"


def configs() -> list[dict]:
    return [load_data("configs", c["name"]) for c in spec()["configs"]]


def references() -> list[str]:
    """``benchmark/reference/`` and every reference package a
    configuration names."""
    return sorted({DEFAULT_REFERENCE} | {reference_name(c) for c in configs()})


def top_level_imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(sub: str = ""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        if os.sep + "tests" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for name in references():
        assert os.path.isfile(os.path.join(BENCH, name, "model.py")), name
        for path in sources(name):
            assert PROGRAM not in top_level_imports(path) and not (
                top_level_imports(path) & FORBIDDEN), path


def run_python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_a_run_loads_no_jax_module():
    """Import the harness, every driver and metric, and run a cell on the
    CPU: the modules loaded then hold no JAX by top-level name."""
    code = """
import glob, os, sys, time
from benchmark import harness
import benchmark.drivers.score, benchmark.drivers.serve, benchmark.drivers.train
for path in glob.glob(os.path.join(harness.BENCH, "metrics", "*.py")):
    name = os.path.basename(path)[:-3]
    if not name.startswith("_"):
        harness.load_reader(name)
r = harness.run_cell("speech.score", 5, 0.2, True, "cpu", time.perf_counter(),
                     overrides={"batch": 8, "pool_batches": 2})
print(r["correct"], r["forbidden"], harness.forbidden_modules())
"""
    assert run_python(code).split("\n")[-2] == "True [] []"


def test_the_reference_loads_no_program_module():
    """Each configuration's reference parses and folds its model, beside
    the frozen reference's ``Reference`` and ``Trainer``: no module of the
    program or of JAX is loaded then."""
    named = [(reference_name(c), f"benchmark/configs/{c['model_file']}") for c in configs()]
    code = f"""
import importlib, sys
from benchmark.reference.model import Reference, Trainer
Reference("benchmark/configs/speech.tflite", "cpu").forward
for name, path in {named!r}:
    importlib.import_module(f"benchmark.{{name}}.model").Reference(path, "cpu")
print(sorted({{n.split(".")[0] for n in sys.modules}} & {{"jax", "jaxlib", "flax",
      "microflow_tpu", "microflow_tpu_torch"}}))
"""
    assert run_python(code).strip() == "[]"
