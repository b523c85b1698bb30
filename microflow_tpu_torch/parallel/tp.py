"""The tensor-parallel train step: a ``TrainableModel``'s own step run on
its params and grads placed on a ``Mesh`` (the JAX package's GSPMD
``jax.jit(m._train_step)`` over ``shard_params``' row shards and a
data-sharded batch, ``tests/test_parallel.py:105-155``).  Its cells meet
in a ``Collectives``: this process's, or ``parallel/distributed.py``'s."""

from __future__ import annotations

import torch

from ..compiler.builder import layer_constants
from ..compiler.ir import refuse_wiring
from ..core.numerics import torch_dtype
from ..train.trainer import Cells, Collectives, FoldBound
from .mesh import Mesh, shard_batch, shard_params

ROWS = ("model", None)  # the spec of a row-sharded leaf


class ShardedTrainer(FoldBound):
    """``model``'s training on ``mesh``: its params and grads placed by
    ``shard_params(mesh, ..., "tp")`` (``params``, ``grads``: ``{layer:
    {name: Placed}}``, on this process's cells), ``predict_quantized_train``
    and ``update_layers`` with ``TrainableModel``'s semantics, and
    ``gather`` for the whole trees.  ``model`` gives the graph, the
    backend, the training configuration and the step, and is not changed.
    The quantized gradient mode only: the f32 twin's sums are f32, whose
    order the batch split would change."""

    def __init__(self, model, mesh: Mesh, collectives: Collectives | None = None):
        refuse_wiring(model.graph, "the sharded step")
        if model.gradient_mode != "quantized":
            raise NotImplementedError(
                "the sharded step runs gradient_mode='quantized' only: the f32 twin sums in "
                "f32, whose order a batch split changes")
        self.model, self.mesh = model, mesh
        coll = collectives if collectives is not None else Collectives(mesh)
        self.cells = coll.cells
        self.params = shard_params(mesh, model.params, "tp", cells=self.cells)
        self.grads = shard_params(mesh, model.grads, "tp", cells=self.cells)
        # rows of each row-sharded FC's W on each model index
        rows = {}
        for key, sub in self.params.items():
            for name, placed in list(sub.items()) + list(self.grads.get(key, {}).items()):
                if placed.spec not in ((), ROWS):
                    raise ValueError(f"{key}/{name}: the sharded step takes replicated leaves "
                                     f"and row shards over 'model', not {placed.spec}")
            w = sub.get("weights")
            if w is not None and w.spec == ROWS:
                if self.grads.get(key, {}).get("weights_gradient", w).spec != ROWS:
                    raise ValueError(f"{key}: W is row-sharded and its accumulator is not")
                rows[key] = [len(r) for r in torch.tensor_split(model.params[key]["weights"],
                                                                mesh.shape["model"])]
        layers = model.graph.layers
        tables = {d: ({layer.index: layer_constants(layer, d) for layer in layers}
                      if model.backend == "pallas" else {},
                      {i: t.to(d) for i, t in model._wzp.items()})
                  for d in dict.fromkeys(coll.device(c) for c in self.cells)}
        self._on = Cells(coll, tables, rows)
        self._set_fold_bound(model._fold_bound if model._fold_bound_holds() else None)

    # --- views and bookkeeping ---

    def _cell_trees(self, tree: dict) -> dict:
        return {c: {key: {name: p.shards[c] for name, p in sub.items()}
                    for key, sub in tree.items()} for c in self.cells}

    def _store(self, tree: dict, per_cell: dict) -> None:
        for c, t in per_cell.items():
            for key, sub in t.items():
                for name, v in sub.items():
                    tree[key][name].shards[c] = v

    def _accumulators(self) -> list[torch.Tensor]:
        """Every cell's conv/dw accumulators, which ``FoldBound`` covers."""
        return [self.grads[f"layer{i}"]["weights_gradient"].shards[c]
                for i in self.model._wzp for c in self.cells]

    # --- public API (TrainableModel's) ---

    def predict_quantized_train(self, xq, gt_q, learning_rate: float = 0.0) -> torch.Tensor:
        """Quantized input and ground truth (the global batch) -> the
        dequantized pre-loss output, the cells' rows in batch order, on the
        first cell's device.  Accumulates gradients on the shards."""
        m, on = self.model, self._on
        xq = torch.as_tensor(xq).to(torch_dtype(m.graph.input_dtype))
        gt_q = torch.as_tensor(gt_q).to(torch_dtype(m.graph.output_dtype))
        sizes = [len(r) for r in torch.tensor_split(xq, self.mesh.shape["data"])]
        xs = shard_batch(self.mesh, xq, self.cells).shards
        gts = shard_batch(self.mesh, gt_q, self.cells).shards
        params, grads = self._cell_trees(self.params), self._cell_trees(self.grads)
        bound = self._fold_bound if self._fold_bound_holds() else self._accumulator_bound()
        fwd = on.run(lambda c: m._forward_phase(on, c, params[c], xs[c], sizes))
        bwd = on.run(lambda c: m._backward_phase(on, c, params[c], fwd[c][0], gts[c], grads[c],
                                                 bound, sizes))
        self._store(self.grads, {c: new for c, (new, _) in bwd.items()})
        self._advance_fold_bound(bound, xq.shape[0])
        return fwd[self.cells[0]][1]

    def update_layers(self, batch_size: int, learning_rate: float) -> None:
        m, on = self.model, self._on
        params, grads = self._cell_trees(self.params), self._cell_trees(self.grads)
        self._store(self.params, on.run(lambda c: m._update_phase(
            on, c, params[c], grads[c], batch_size, learning_rate)))
        self._store(self.grads, {c: {key: {k: torch.zeros_like(v) for k, v in g[key].items()}
                                     for key in m._updated_keys(g)} for c, g in grads.items()})
        self._set_fold_bound(0)  # accumulators zeroed

    def gather(self) -> tuple[dict, dict]:
        """The whole ``params`` and ``grads`` trees (row shards gathered
        over ``model``), on the first cell's device."""
        return self._whole(self.params), self._whole(self.grads)

    def _whole(self, tree: dict) -> dict:
        out = {}
        for key, sub in tree.items():
            out[key] = {}
            for name, placed in sub.items():
                parts = {c: placed.shards[c] for c in self.cells}
                if placed.spec == ROWS:
                    parts = self._on.coll.gather(parts, "model", 0, self._on.rows[key])
                out[key][name] = parts[self.cells[0]]
        return out
