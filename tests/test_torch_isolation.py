"""The torch port stands alone: importing it, ``chip_smoke.py``,
``bench_torch.py`` or ``scripts/torch_multiprocess_worker.py``, parsing a model (natively) and serving a request loads
neither JAX nor any module of ``microflow_tpu``;
and without CUDA the port's default device raises instead of carrying on on
the CPU."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = r"""
import sys
import microflow_tpu_torch
import microflow_tpu_torch.compiler.builder, microflow_tpu_torch.kernels.build
import microflow_tpu_torch.core.fixedpoint, microflow_tpu_torch.compiler.fixed_forward
import microflow_tpu_torch.kernels.flatpack, microflow_tpu_torch.kernels.colfc
import microflow_tpu_torch.kernels.megakernel, microflow_tpu_torch.kernels.packed
import microflow_tpu_torch.models, microflow_tpu_torch.ops, microflow_tpu_torch.frontend
import microflow_tpu_torch.train, microflow_tpu_torch.train.trainer
import microflow_tpu_torch.__main__, microflow_tpu_torch.utils, microflow_tpu_torch.samples
import microflow_tpu_torch.utils.trace
import microflow_tpu_torch.models.synth, microflow_tpu_torch.frontend.export
import microflow_tpu_torch.compiler.expansion
import microflow_tpu_torch.parallel, microflow_tpu_torch.parallel.executor
import microflow_tpu_torch.parallel.mesh, microflow_tpu_torch.native
import microflow_tpu_torch.frontend.native_backend
import microflow_tpu_torch.parallel.tp, microflow_tpu_torch.parallel.distributed
import chip_smoke, bench_torch
sys.path.insert(0, "scripts")
import torch_multiprocess_worker
# the lazy imports too: a native parse and fold, and a served request
from microflow_tpu_torch.models import sine
server = microflow_tpu_torch.parallel.BatchServer(sine(device="cpu"), max_batch=8)
try:
    server.submit([[0.5]]).result(timeout=60)
finally:
    server.stop()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "microflow_tpu" or m.startswith("microflow_tpu."))
print(repr(bad))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from microflow_tpu_torch import compile_tflite
    from microflow_tpu_torch.models import model_path

    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            compile_tflite(model_path("sine"), device=device)


def test_chip_smoke_fails_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out
