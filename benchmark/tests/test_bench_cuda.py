"""Each cell once on the card, briefly (``-m cuda``; skips without a card)."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.harness import ROOT, spec


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu", result
