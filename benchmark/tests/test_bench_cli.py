"""The command as the driver runs it: no result without a card or without
the program, and a cell added as a data file is found without an edit."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.harness import BENCH, ROOT

ARGS = ["--workload", "speech.score", "--seed", "1", "--seconds", "1", "--trace", "0"]


def run(cwd, args=ARGS, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = run(tmp_path, env=env)
    assert out.returncode != 0 and out.stdout == ""


def test_a_new_workload_file_is_found_without_an_edit(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(BENCH, "workloads", "speech.score.json")) as f:
        w = json.load(f)
    w["traffic"].update(batch=8, pool_batches=2)
    with open(tmp_path / "benchmark" / "workloads" / "speech.tiny.json", "w") as f:
        json.dump(w, f)
    spec["workloads"].append({"name": "speech.tiny", "config": "speech", "traffic": "tiny",
                              "chips": 1, "why": w["why"]})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "speech.score" in m.get("workloads", []):
            m["workloads"].append("speech.tiny")
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(spec, f)
    code = (f"import sys, time; sys.path[:0] = [{str(tmp_path)!r}, {ROOT!r}]\n"
            "from benchmark import harness\n"
            "assert harness.ROOT == sys.path[0]\n"
            "r = harness.run_cell('speech.tiny', 3, 0.2, False, 'cpu', time.perf_counter())\n"
            "print(r['correct'], sorted(r['metrics']))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "True ['score_inferences_per_s', 'setup_s']"
