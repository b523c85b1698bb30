"""The port's command line (``python -m microflow_tpu_torch``) and
``bench_torch.py`` on the CPU (``--device cpu``): the commands run in
process, against the JAX package's CLI where both print the same thing;
one subprocess each for ``python -m microflow_tpu_torch`` and for
``bench_torch.py``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from microflow_tpu.__main__ import main as jmain
from microflow_tpu.models import synth as jsynth
from microflow_tpu_torch import compile_tflite
from microflow_tpu_torch.__main__ import main, train_backend
from microflow_tpu_torch.utils import load_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SINE = os.path.join(ROOT, "models", "sine.tflite")
SPEECH = os.path.join(ROOT, "models", "speech.tflite")

sys.path.insert(0, ROOT)
try:
    import bench_torch
finally:
    sys.path.remove(ROOT)


def env():
    e = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "MFT_BACKEND")}
    e["PYTHONPATH"] = ROOT
    return e


def test_inspect_prints_the_jax_clis_lines(capsys):
    main(["inspect", SPEECH])
    got = capsys.readouterr().out
    jmain(["inspect", SPEECH])
    assert got == capsys.readouterr().out
    assert "DepthwiseConv2D" in got and "MACs/inference: 336,000" in got


@pytest.mark.parametrize("backend", [None, "xla", "pallas", "colfc"])
def test_predict_golden(capsys, backend):
    argv = ["predict", SINE, "--fill", "0.5", "--device", "cpu"]
    main(argv + (["--backend", backend] if backend else []))
    assert "0.41348344" in capsys.readouterr().out


def test_predict_batch_and_input(capsys, tmp_path):
    x = np.full((3, 1), 0.5, np.float32)
    np.save(tmp_path / "x.npy", x)
    main(["predict", SINE, "--batch", "3", "--input", str(tmp_path / "x.npy"),
          "--device", "cpu"])
    assert capsys.readouterr().out.count("0.41348344") == 3


@pytest.mark.parametrize("kind", ["lenet", "full_ops"])
def test_synth_writes_jax_bytes(capsys, tmp_path, kind):
    out = str(tmp_path / f"{kind}.tflite")
    main(["synth", kind, out])
    with open(out, "rb") as f:
        assert f.read() == getattr(jsynth, kind)()
    assert f"wrote {out}" in capsys.readouterr().out


def test_train_sine_save_load_export(capsys, tmp_path):
    """The JAX CLI's train test (tests/test_cli.py): the retarget task over
    4 epochs, losses falling; then the checkpoint and the export load."""
    ck, exported = str(tmp_path / "ck.npz"), str(tmp_path / "trained.tflite")
    x = np.random.default_rng(1).uniform(0, 2 * np.pi, (128, 1)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", (x / 4).astype(np.float32))
    m, xs = main(["train", SINE, "--x", str(tmp_path / "x.npy"), "--y", str(tmp_path / "y.npy"),
                  "--epochs", "4", "--batch", "64", "--lr", "0.05", "--save", ck,
                  "--export", exported, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "train: backend xla on cpu" in out
    mse = [float(line.split()[-1]) for line in out.splitlines() if line.startswith("epoch")]
    assert len(mse) == 4 and mse[-1] < mse[0]
    assert np.array_equal(xs, x)
    loaded = load_params(ck, "cpu")
    for layer, arrays in m.params.items():
        for k, v in arrays.items():
            assert torch.equal(loaded[layer][k], v), (layer, k)
    xq = m.quantize_input(x)
    m2 = compile_tflite(exported, backend="xla", device="cpu")
    diff = (m2.predict_inner(xq).to(torch.int32) - m.predict_inner(xq).to(torch.int32)).abs()
    assert int(diff.max()) <= 1

    m3, _ = main(["train", SINE, "--epochs", "1", "--load", ck, "--device", "cpu",
                  "--backend", "pallas", "--lr", "0"])
    assert "retarget demo" in capsys.readouterr().out
    assert m3.backend == "pallas"
    assert torch.equal(m3.predict_inner(xq), m.predict_inner(xq))  # lr 0: the loaded params


@pytest.mark.parametrize("backend", ["flat", "colfc", "fused"])
def test_train_refuses_a_baked_backend(backend):
    with pytest.raises(SystemExit) as e:
        main(["train", SINE, "--epochs", "1", "--backend", backend, "--device", "cpu"])
    assert e.value.code != 0 and f"backend {backend!r} bakes the weights" in str(e.value.code)


def test_train_backend_rule(monkeypatch):
    monkeypatch.delenv("MFT_BACKEND", raising=False)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert (train_backend(None, cuda), train_backend(None, cpu)) == ("pallas", "xla")
    assert train_backend("xla", cuda) == "xla"
    monkeypatch.setenv("MFT_BACKEND", "pallas")
    assert train_backend(None, cpu) == "pallas"
    monkeypatch.setenv("MFT_BACKEND", "flat")
    with pytest.raises(SystemExit, match="'flat' bakes"):
        main(["train", SINE, "--epochs", "1", "--device", "cpu"])


@pytest.mark.parametrize("cmd", ["predict", "expansion", "train"])
def test_unknown_mft_backend_raises(monkeypatch, cmd):
    monkeypatch.setenv("MFT_BACKEND", "bogus")
    with pytest.raises(SystemExit, match="MFT_BACKEND='bogus' is not a known backend"):
        main([cmd, SINE, "--device", "cpu"])


def test_mft_backend_picks_the_default(monkeypatch):
    monkeypatch.setenv("MFT_BACKEND", "pallas")
    assert compile_tflite(SINE, device="cpu").backend == "pallas"
    monkeypatch.delenv("MFT_BACKEND")
    assert compile_tflite(SINE, device="cpu").backend == "xla"  # auto on the CPU


def test_expansion(capsys):
    main(["expansion", SPEECH, "--batch", "2", "--backend", "pallas", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "backend: pallas   device: cpu   batch: 2" in out
    assert "qdwconv_reference" in out and "qgemm_reference [M=2, K=4000, N=4]" in out


def test_no_device_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["predict", SINE])


def test_select_golden_keys_by_name():
    """As ``tests/test_cli.py`` holds ``bench.py``'s."""
    assert bench_torch.select_golden("sine", (1,)) is not None
    assert bench_torch.select_golden("person_detect", (96, 96, 1)) is not None
    assert bench_torch.select_golden("my_custom_net", (96, 96, 1)) is None
    assert bench_torch.select_golden("sine_variant", (1,)) is None
    assert bench_torch.select_golden("sine", (2,)) is None


def test_bench_wrong_golden_prints_parity_and_fails(monkeypatch, capsys):
    gin, want = bench_torch.GOLDENS["sine"]
    monkeypatch.setitem(bench_torch.GOLDENS, "sine", (gin, want + np.float32(1 / 256)))
    assert bench_torch.main(["--model", SINE, "--device", "cpu", "--smoke"]) == 1
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == {"metric": "sine_parity", "value": 0, "unit": "bool",
                                    "vs_baseline": 0}


def test_bench_smoke_subprocess():
    out = subprocess.run([sys.executable, "bench_torch.py", "--model", SINE, "--device", "cpu",
                          "--smoke"], cwd=ROOT, env=env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    (line,) = out.stdout.splitlines()
    rec = json.loads(line)
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == "sine_inferences_per_sec_cpu" and rec["value"] > 0
    assert rec["unit"] == "inferences/s"
    assert "parity: sine golden output bit-exact" in out.stderr
    assert "device: cpu; backend: xla" in out.stderr and "batch=64" in out.stderr


def test_cli_subprocess_bench():
    """``python -m microflow_tpu_torch bench`` runs ``bench_torch.py``."""
    out = subprocess.run([sys.executable, "-m", "microflow_tpu_torch", "bench", "models/sine.tflite",
                          "--batch", "16", "--iters", "2", "--backend", "pallas", "--device",
                          "cpu"], cwd=ROOT, env=env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.splitlines()[-1])
    assert rec["metric"] == "sine_inferences_per_sec_cpu" and rec["value"] > 0
    assert "backend: pallas" in out.stderr and "batch=16" in out.stderr
