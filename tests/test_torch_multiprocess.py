"""The port's two-process tier (``scripts/torch_multiprocess_worker.py`` over
``microflow_tpu_torch.parallel.distributed``), the counterpart of
``tests/test_multiprocess.py``: two CPU processes join a gloo group through
a ``file://`` rendezvous in a fresh directory (no port to race for) and
each checks itself against the one-process run; this process then holds
the shards the workers wrote against the JAX package's single-process
step.  Tolerances: none for the shards and outputs (bit-equal), 1e-4 for
the cross-process sum (the JAX worker's).  A worker that fails or runs
past its time limit fails the test: nothing skips."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from microflow_tpu import models as jmodels
from microflow_tpu import compile_tflite as jcompile

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
WORKER = os.path.join(ROOT, "scripts", "torch_multiprocess_worker.py")
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def run_workers(mode: str, tmp_path) -> list[dict]:
    out_dir = tmp_path / "out"
    rdv = f"file://{tmp_path / 'rdv'}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, WORKER, rdv, "2", str(i), mode, "--device", "cpu",
                               "--backend", "gloo", "--out", str(out_dir)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{mode}: a worker ran past 120 s")
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i}: OK" in out, out[-2000:]
    return [dict(np.load(out_dir / f"rank{i}.npz")) for i in range(2)]


def test_two_process_data_parallel_inference(tmp_path):
    """``infer``: each rank's half of sine's 32-row linspace batch equals the
    JAX package's single-process forward on those rows."""
    shards = run_workers("infer", tmp_path)
    m = jcompile(os.path.join(ROOT, "models", "sine.tflite"), name="sine")
    xs = np.linspace(0.0, 2 * np.pi, 32, dtype=np.float32).reshape(32, 1)
    want = np.asarray(m.predict(xs))
    got = np.concatenate([s["sine/output"] for s in shards])
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert abs(float(got.astype(np.float64).sum()) - float(want.sum())) < 1e-4


def test_two_process_tensor_parallel_train_step(tmp_path):
    """``train_tp``: speech's step and update with the FC row-sharded over a
    ``model`` axis across the two processes; every shard each rank wrote
    (the grads after the step, the params and grads after the update) and
    the output equal the JAX single-process replicated step's rows (the
    update with jit disabled)."""
    from torch_multiprocess_worker import TRAIN_BATCH, TRAIN_LR, train_inputs

    shards = run_workers("train_tp", tmp_path)
    jm = jmodels.speech_trainable()
    xq, gt = train_inputs()
    out = np.asarray(jm.predict_quantized_train(xq, gt, 0.0))
    trees = {"step_grads": {k: {n: np.asarray(v) for n, v in d.items()}
                            for k, d in jm.grads.items()}}
    with jax.disable_jit():
        jm.update_layers(TRAIN_BATCH, TRAIN_LR)
    trees["params"] = {k: {n: np.asarray(v) for n, v in d.items()} for k, d in jm.params.items()}
    trees["grads"] = {k: {n: np.asarray(v) for n, v in d.items()} for k, d in jm.grads.items()}
    seen = set()
    for rank, arrays in enumerate(shards):
        assert arrays["output"].tobytes() == out.tobytes(), rank
        for name, piece in arrays.items():
            if name == "output":
                continue
            what, layer, leaf, cell = name.split("/")
            i, j = map(int, cell.split("_"))
            assert j == rank and 0 <= i < 4
            whole = trees[what][layer][leaf]
            want = (np.array_split(whole, 2)[j] if piece.shape != whole.shape else whole)
            assert piece.dtype == want.dtype and piece.tobytes() == want.tobytes(), name
            seen.add((what, layer, leaf, piece.shape != whole.shape))
    # the FC's W and accumulator were row-sharded, everything else whole
    assert ("params", "layer2", "weights", True) in seen
    assert ("step_grads", "layer2", "weights_gradient", True) in seen
    assert ("params", "layer2", "c2", False) in seen
    assert np.count_nonzero(trees["step_grads"]["layer2"]["weights_gradient"])


def test_backend_is_named_and_nccl_needs_a_card_a_rank(tmp_path, monkeypatch):
    """``distributed.init`` takes the backend from its caller: an unknown
    name raises ``ValueError``, and NCCL with fewer CUDA devices than ranks
    raises ``RuntimeError`` naming the cause, before any rendezvous (it
    never falls back to gloo)."""
    import torch

    from microflow_tpu_torch.parallel import distributed

    rdv = f"file://{tmp_path / 'rdv'}"
    with pytest.raises(ValueError, match="choose one of"):
        distributed.init(rdv, 2, 0, "mpi")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="NCCL needs a CUDA device a rank"):
        distributed.init(rdv, n + 1, 0, "nccl")
    # on a launcher's host, the ranks counted are this host's, not the group's
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(n + 1))
    with pytest.raises(RuntimeError, match=f"{n + 1} ranks on this host"):
        distributed.init(rdv, 2 * (n + 1), 0, "nccl")
    assert not torch.distributed.is_initialized()
