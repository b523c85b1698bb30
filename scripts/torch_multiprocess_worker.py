#!/usr/bin/env python3
"""One rank of the port's two-process tier (``microflow_tpu_torch``, no
JAX): the counterpart of ``scripts/multiprocess_worker.py``.

    python3 scripts/torch_multiprocess_worker.py INIT_METHOD NUM_PROCS PROC_ID MODE
        [--device cpu|cuda] [--backend gloo|nccl] [--out DIR]
        [--model sine|person_detect ...] [--model-backend NAME ...] [--rows N ...]

``INIT_METHOD`` is the rendezvous (``file:///tmp/x/rdv`` or
``tcp://localhost:<port>``); each of the ``NUM_PROCS`` ranks runs this with
its ``PROC_ID``.  Modes:

* ``infer``: each ``--model`` (sine by default) in turn over a global
  ``data`` axis: each rank predicts its contiguous half of a ``--rows``
  (32) row ``linspace`` batch through ``--model-backend`` (the model's
  default), which must equal the one-process forward on those rows bit
  for bit; then an ``all_reduce`` of the outputs' float64 sums, within
  1e-4 of the one-process sum (the JAX worker's tolerance).  Prints the
  launches of the rank's forward of each model.  ``--model-backend`` and
  ``--rows`` take one value for every model or one a model.
* ``train_tp``: speech's train step (B = 8, the JAX worker's seed-0 inputs)
  and an update at lr 0.5 on a ``[4 data, NUM_PROCS model]`` mesh whose
  ``model`` axis spans the ranks (``parallel/distributed.py``), the FC's
  weights and accumulator row-sharded over it, through ``--model-backend``
  (``xla`` by default); params, grads and the output on every cell this
  rank holds must be bit-equal to the one-process replicated step computed
  here, the grads also after the step.

Each rank writes what it holds to ``DIR/rank<i>.npz`` (``infer``: its
rows' outputs as ``<model>/output``; ``train_tp``: ``output`` and every shard as
``<what>/<layer>/<name>/<data>_<model>``, ``what`` one of ``step_grads``,
``params``, ``grads``) and prints ``proc <i>: OK``; a failed check
raises.  ``--device cuda`` puts the rank's tensors on ``cuda:<i % count>``;
two ranks on one card run ``--backend gloo``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from microflow_tpu_torch.kernels import LAUNCHES  # noqa: E402
from microflow_tpu_torch.models import model_path  # noqa: E402
from microflow_tpu_torch.parallel import distributed  # noqa: E402
from microflow_tpu_torch.parallel.tp import ShardedTrainer  # noqa: E402

TRAIN_BATCH = 8
TRAIN_LR = 0.5
TRAIN_DATA = 4  # data cells a rank


def train_inputs() -> tuple[np.ndarray, np.ndarray]:
    """The JAX worker's speech batch (``scripts/multiprocess_worker.py:73-77``)."""
    rng = np.random.default_rng(0)
    xq = rng.integers(-128, 128, size=(TRAIN_BATCH, 1960)).astype(np.int8)
    gt = np.full((TRAIN_BATCH, 4), -128, np.int8)
    gt[:, 1] = 127
    return xq, gt


def per_model(values: list, n: int, flag: str) -> list:
    """``values`` for each of ``n`` models: one for all, or one a model."""
    if len(values) not in (1, n):
        raise SystemExit(f"{flag}: give one value or one a model ({n}), not {len(values)}")
    return values * n if len(values) == 1 else values


def infer(args, rank: int, world: int, dev: torch.device) -> dict:
    models = args.model
    res = {"models": {}, "launches": {}, "arrays": {}}
    for name, backend, rows in zip(models,
                                   per_model(args.model_backend, len(models), "--model-backend"),
                                   per_model(args.rows, len(models), "--rows")):
        one = infer_model(name, backend, rows, rank, world, dev)
        res["launches"][name] = one.pop("launches")
        res["arrays"][f"{name}/output"] = one.pop("output")
        res["models"][name] = one
    return res


def infer_model(name: str, backend: str | None, n: int, rank: int, world: int,
                dev: torch.device) -> dict:
    from microflow_tpu_torch import compile_tflite

    m = compile_tflite(model_path(name), name=name, backend=backend, device=dev)
    g = m.graph
    if name == "sine":
        xs = np.linspace(0.0, 2 * np.pi, n, dtype=np.float32).reshape(n, 1)
    else:
        xs = np.linspace(0.0, 1.0, n * int(np.prod(g.input_shape)), dtype=np.float32)
        xs = xs.reshape(n, *g.input_shape)
    xq = m.quantize_input(xs)
    local = torch.tensor_split(xq, world)[rank]
    LAUNCHES.clear()
    out = m.predict_quantized(local)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = dict(LAUNCHES)
    want = m.predict_quantized(xq)  # the one-process forward of the whole batch
    start = sum(c.shape[0] for c in torch.tensor_split(xq, world)[:rank])
    if not torch.equal(out, want[start:start + local.shape[0]]):
        raise AssertionError(f"rank {rank}: its rows differ from the one-process forward")
    total = float(distributed.all_reduce_sum(out.to(torch.float64).sum()).item())
    expected = float(want.to(torch.float64).sum().item())
    if abs(total - expected) >= 1e-4:
        raise AssertionError(f"cross-process sum {total} vs one-process {expected}")
    return {"rows": local.shape[0], "backend": m.backend, "launches": launches,
            "total": total, "expected": expected, "output": out.cpu().numpy()}


def train_tp(args, rank: int, world: int, dev: torch.device) -> dict:
    from microflow_tpu_torch.models import speech_trainable

    backend = args.model_backend[0] or "xla"
    mesh, cells = distributed.process_mesh([dev] * TRAIN_DATA, world, rank)
    coll = distributed.ProcessCollectives(mesh, cells)
    tr = ShardedTrainer(speech_trainable(backend=backend, device=dev), mesh, collectives=coll)
    if tr.params["layer2"]["weights"].spec != ("model", None):
        raise AssertionError("the FC weights are not row-sharded over 'model'")
    ref = speech_trainable(backend=backend, device=dev)
    xq, gt = train_inputs()
    LAUNCHES.clear()
    out = tr.predict_quantized_train(xq, gt)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = dict(LAUNCHES)
    want = ref.predict_quantized_train(torch.from_numpy(xq).to(dev), torch.from_numpy(gt).to(dev))
    if not torch.equal(out, want):
        raise AssertionError("the output differs from the one-process step")
    arrays = {"output": out.cpu().numpy()}

    def same(what: str, tree: dict, whole: dict) -> None:
        """Every shard this rank holds against its rows of the whole leaf."""
        for key, sub in tree.items():
            for name, placed in sub.items():
                for c in cells:
                    rows = whole[key][name]
                    if placed.spec == ("model", None):
                        rows = torch.tensor_split(rows, world)[c[1]]
                    if not torch.equal(placed.shards[c], rows):
                        raise AssertionError(f"{what}/{key}/{name} differs on cell {c}")
                    arrays[f"{what}/{key}/{name}/{c[0]}_{c[1]}"] = rows.cpu().numpy()

    same("step_grads", tr.grads, ref.grads)
    nonzero = {k: int(v["weights_gradient"].count_nonzero()) for k, v in ref.grads.items()}
    tr.update_layers(TRAIN_BATCH, TRAIN_LR)
    ref.update_layers(TRAIN_BATCH, TRAIN_LR)
    same("params", tr.params, ref.params)
    same("grads", tr.grads, ref.grads)
    return {"cells": [list(c) for c in cells], "launches": launches, "backend": backend,
            "nonzero_weight_gradients": nonzero, "arrays": arrays}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("init_method")
    ap.add_argument("num_procs", type=int)
    ap.add_argument("proc_id", type=int)
    ap.add_argument("mode", choices=("infer", "train_tp"))
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--backend", default="gloo", choices=distributed.BACKENDS)
    ap.add_argument("--out", default=None)
    ap.add_argument("--model", nargs="+", default=["sine"], choices=("sine", "person_detect"))
    ap.add_argument("--model-backend", nargs="+", default=[None])
    ap.add_argument("--rows", nargs="+", type=int, default=[32])
    args = ap.parse_args()
    rank, world = args.proc_id, args.num_procs
    dev = torch.device("cpu")
    if args.device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    distributed.init(args.init_method, world, rank, args.backend)
    try:
        res = (infer if args.mode == "infer" else train_tp)(args, rank, world, dev)
        arrays = res.pop("arrays")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            np.savez(os.path.join(args.out, f"rank{rank}.npz"), **arrays)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "mode": args.mode, "device": str(dev),
                      "dist_backend": args.backend, **res}), flush=True)
    print(f"proc {rank}: OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
