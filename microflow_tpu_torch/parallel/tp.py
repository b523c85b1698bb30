"""The tensor-parallel train step: a ``TrainableModel``'s step and update
computed from its params and grads placed on a ``Mesh``.

The JAX package gets this from GSPMD: ``jax.jit(m._train_step)`` over
``shard_params``' row shards and a data-sharded batch
(``tests/test_parallel.py:105-155``).  Here the step is written out, cell
by cell: cell ``(i, j)`` of a ``[n_data, n_model]`` mesh holds batch chunk
``i`` (``shard_batch``: contiguous chunks in batch order), the whole of
every replicated leaf and, of a row-sharded FC weight matrix and its
gradient accumulator (``tp_spec``: ``("model", None)``), rows ``j`` of K.
The layer functions are the trainer's own (``train/gradients.py``,
``train/optimizer.py``, ``ops/fully_connected.py``), run on the shards; the
cells meet only in sums over one axis of the mesh (``Collectives``).  Every
sum is of integers, or of float64 values that are integers below 2**53, so
it is exact in any order and the step is bit-equal to the replicated one:

* a sharded FC forward: each cell's ``acc - rowsum * w_zp`` over its rows
  of K from its columns of ``x`` (``fc_partial``, float64), summed over
  ``model``; then ``- C2 + C3`` and the epilogue, once (``fc_requant``).
  The JAX package computes this product in XLA, outside any Pallas kernel,
  so it runs as the plain integer product on every backend.  Other layers
  run the trainer's backend (``apply_layer``): on CUDA with ``"pallas"``
  a depthwise layer launches ``qdwconv`` and an unsharded FC ``qgemm``;
* FC backward: ``dW`` (the cell's rows) and the masked ``dOut``'s integer
  column sums summed over ``data`` in int64 before the wrap to i32 and the
  f32 conversion (``fc_weight_sums``), ``c0_gradient`` added once; ``dIn``
  from the cell's rows of W is the cell's columns, gathered over ``model``
  where a trained layer lies before the FC;
* conv/dw weight accumulators: where the fold is the plain sum
  (``optimizer.fold_is_plain_sum`` with the global batch's margin), the
  per-sample ``dW_b`` summed in int64 over ``data``; else the saturating
  serial fold, which is not associative: every ``data`` cell's ``dW_b``
  gathered in batch order, folded on the first ``data`` cell and broadcast.
  A depthwise layer's ``c0_gradient``: float64 sums over ``data``, rounded
  to f32 once.  The host bound on the accumulators is C1's, the helper
  ``TrainableModel`` uses (``train.trainer.FoldBound``), over every cell's
  accumulator tensors;
* update: the clip norm's sum of squares (``clip_norm_squares``) summed
  over ``model`` and rounded to f32 once; C2 refolded from W's int64
  column sums summed over ``model``; C0 and the replicated leaves update
  on every cell alike.  The loss output is the cells' rows concatenated in
  batch order.

``Collectives`` sums within this process; ``parallel/distributed.py``
gives the same interface across processes, its ``model`` sums an
``all_reduce`` (which gloo supports on CUDA tensors too) and its
``broadcast`` within the process.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compiler.builder import _bias0, apply_layer, layer_constants
from ..compiler.ir import (
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    ReshapeLayer,
    refuse_wiring,
)
from ..core.numerics import f32, torch_dtype
from ..core.quantize import dequantize
from ..core.tensor import reshape_2d
from ..ops.fully_connected import fc_partial, fc_requant
from ..train import gradients, losses, optimizer
from ..train.trainer import FoldBound
from .mesh import Mesh, shard_batch, shard_params

AXIS = {"data": 0, "model": 1}
ROWS = ("model", None)  # the spec of a row-sharded leaf


def split_sizes(n: int, parts: int) -> list[int]:
    """The sizes of ``torch.tensor_split``'s ``parts`` pieces of ``n``."""
    return [len(a) for a in np.array_split(np.arange(n), parts)]


class Collectives:
    """Sums over one axis of ``mesh`` among the cells of this process
    (``cells``: here every cell).  ``parts`` maps a cell ``(data, model)``
    to its tensor; each method returns such a map over ``cells``, each
    cell's tensor on that cell's device, and may hand cells of one device
    the same tensor."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.cells = list(np.ndindex(*mesh.devices.shape))

    def device(self, cell) -> torch.device:
        return self.mesh.devices[cell]

    def groups(self, axis: str) -> list[list]:
        """This process's cells by the other axis's index, each group in
        the order of its index on ``axis``."""
        d = AXIS[axis]
        out = {}
        for c in sorted(self.cells, key=lambda c: (c[1 - d], c[d])):
            out.setdefault(c[1 - d], []).append(c)
        return list(out.values())

    def all_reduce(self, parts: dict, axis: str) -> dict:
        """The sum of each group's tensors along ``axis``, on every cell of
        the group."""
        out = {}
        for group in self.groups(axis):
            total = parts[group[0]]
            for c in group[1:]:
                total = total + parts[c].to(total.device)
            out.update({c: total.to(self.device(c)) for c in group})
        return out

    def broadcast(self, parts: dict, axis: str) -> dict:
        """The tensor of index 0 along ``axis`` on every cell of its group
        (``parts`` needs only those)."""
        out = {}
        for group in self.groups(axis):
            src = parts[group[0]]
            out.update({c: src.to(self.device(c)) for c in group})
        return out

    def gather(self, parts: dict, axis: str, dim: int, sizes: list[int]) -> dict:
        """Each group's pieces concatenated along ``dim`` in the order of
        their index on ``axis`` (piece k is ``sizes[k]`` long): an
        ``all_reduce`` of the pieces placed in zeros of the whole's shape,
        exact, as the pieces are disjoint."""
        d = AXIS[axis]
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        padded = {}
        for c, p in parts.items():
            shape = list(p.shape)
            shape[dim] = int(offsets[-1])
            z = torch.zeros(shape, dtype=p.dtype, device=p.device)
            z.narrow(dim, int(offsets[c[d]]), int(sizes[c[d]])).copy_(p)
            padded[c] = z
        return self.all_reduce(padded, axis)


class ShardedTrainer(FoldBound):
    """``model``'s training on ``mesh``: its params and grads placed by
    ``shard_params(mesh, ..., "tp")`` (``params``, ``grads``: ``{layer:
    {name: Placed}}``, on this process's cells), ``predict_quantized_train``
    and ``update_layers`` with ``TrainableModel``'s semantics, and
    ``gather`` for the whole trees.  ``model`` gives the graph, the
    backend and the training configuration and is not changed.  The
    quantized gradient mode only: the f32 twin's sums are f32, whose order
    the batch split would change."""

    def __init__(self, model, mesh: Mesh, collectives: Collectives | None = None):
        refuse_wiring(model.graph, "the sharded step")
        if model.gradient_mode != "quantized":
            raise NotImplementedError(
                "the sharded step runs gradient_mode='quantized' only: the f32 twin sums in "
                "f32, whose order a batch split changes")
        self.model, self.mesh = model, mesh
        self.coll = collectives if collectives is not None else Collectives(mesh)
        self.cells = self.coll.cells
        self.params = shard_params(mesh, model.params, "tp", cells=self.cells)
        self.grads = shard_params(mesh, model.grads, "tp", cells=self.cells)
        self._n_model = mesh.shape["model"]
        # rows of each row-sharded FC's W on each model index
        self._rows = {}
        for key, sub in self.params.items():
            for name, placed in list(sub.items()) + list(self.grads.get(key, {}).items()):
                if placed.spec not in ((), ROWS):
                    raise ValueError(f"{key}/{name}: the sharded step takes replicated leaves "
                                     f"and row shards over 'model', not {placed.spec}")
            w = sub.get("weights")
            if w is not None and w.spec == ROWS:
                if self.grads.get(key, {}).get("weights_gradient", w).spec != ROWS:
                    raise ValueError(f"{key}: W is row-sharded and its accumulator is not")
                self._rows[key] = split_sizes(model.params[key]["weights"].shape[0],
                                              self._n_model)
        devices = dict.fromkeys(self.coll.device(c) for c in self.cells)
        layers = model.graph.layers
        self._consts = {d: ({layer.index: layer_constants(layer, d) for layer in layers}
                            if model.backend == "pallas" else {}) for d in devices}
        self._wzp = {d: {i: t.to(d) for i, t in model._wzp.items()} for d in devices}
        self._set_fold_bound(model._fold_bound if model._fold_bound_holds() else None)

    # --- views and bookkeeping ---

    def _cell_tree(self, tree: dict, cell) -> dict:
        return {key: {name: p.shards[cell] for name, p in sub.items()}
                for key, sub in tree.items()}

    def _store(self, tree: dict, per_cell: dict) -> None:
        for c, t in per_cell.items():
            for key, sub in t.items():
                for name, v in sub.items():
                    tree[key][name].shards[c] = v

    def _cols(self, key: str, cell) -> slice:
        """The columns of the FC's input that cell's rows of W multiply."""
        sizes = self._rows[key]
        start = sum(sizes[:cell[1]])
        return slice(start, start + sizes[cell[1]])

    def _accumulators(self) -> list[torch.Tensor]:
        """Every cell's conv/dw accumulators, which ``FoldBound`` covers."""
        return [self.grads[f"layer{layer.index}"]["weights_gradient"].shards[c]
                for layer in self.model._backward_layers
                if isinstance(layer, (Conv2DLayer, DepthwiseConv2DLayer)) for c in self.cells]

    # --- the step ---

    def _fc_forward(self, layer, params: dict, x: dict) -> dict:
        key = f"layer{layer.index}"
        partial = {}
        for c in self.cells:
            x2 = reshape_2d(x[c]) if layer.flatten_input else x[c]
            partial[c] = fc_partial(x2[:, self._cols(key, c)], params[c][key]["weights"],
                                    w_zp=layer.w_q.zp0)
        total = self.coll.all_reduce(partial, "model")
        return {c: fc_requant(total[c], bias0=_bias0(layer, params[c][key]), c1=layer.c1,
                              c2=params[c][key]["c2"], c3=layer.c3,
                              out_scale=layer.out_q.scale0, out_zp=layer.out_q.zp0,
                              activation=layer.activation, out_dtype=x[c].dtype)
                for c in self.cells}

    def _fold(self, key: str, grads: dict, dW_b: dict, bound: int, batch: int) -> None:
        """The conv/dw accumulators plus the batch's per-sample gradients."""
        acc = {c: grads[c][key]["weights_gradient"] for c in self.cells}
        if optimizer.fold_is_plain_sum(bound, batch):
            total = self.coll.all_reduce({c: dW_b[c].to(torch.int64).sum(0) for c in self.cells},
                                         "data")
            new = {c: (acc[c].to(torch.int64) + total[c]).to(torch.int32) for c in self.cells}
        else:
            full = self.coll.gather(dW_b, "data", 0, self._batch_sizes)
            first = {g[0]: optimizer.accumulate_gradient_4d_fold(full[g[0]], acc[g[0]], bound)
                     for g in self.coll.groups("data")}
            new = self.coll.broadcast(first, "data")
        for c in self.cells:
            grads[c][key]["weights_gradient"] = new[c]

    def _train_step(self, xq: dict, gt: dict, bound: int, batch: int) -> dict:
        m, cells = self.model, self.cells
        params = {c: self._cell_tree(self.params, c) for c in cells}
        keep = set(m.backward_indices)
        acts, x = {}, xq
        for layer in m.graph.layers:
            if f"layer{layer.index}" in self._rows:
                y = self._fc_forward(layer, params, x)
            else:
                y = {c: apply_layer(layer, params[c], x[c], m.backend,
                                    self._consts[self.coll.device(c)].get(layer.index))
                     for c in cells}
            if layer.index in keep:
                acts[layer.index] = (x, y)
            x = y
        loss_layer = m.graph.layers[m.loss_index]
        loss_out = acts[m.loss_index][1]
        if m.loss == "mse":
            g = {c: losses.mse_grad(loss_out[c], gt[c]) for c in cells}
        else:
            g = {c: losses.crossentropy_grad(loss_out[c], m.graph.output_q.scale0,
                                             m.graph.output_q.zp0, gt[c],
                                             in_scale=loss_layer.out_q.scale0) for c in cells}

        grads = {c: {k: dict(v) for k, v in self._cell_tree(self.grads, c).items()}
                 for c in cells}
        first = m._backward_layers[0] if m._backward_layers else None
        for layer in reversed(m._backward_layers):
            key = f"layer{layer.index}"
            x_in, y_out = acts[layer.index]
            if isinstance(layer, FullyConnectedLayer):
                sharded = key in self._rows
                x2 = {c: reshape_2d(x_in[c]) if layer.flatten_input else x_in[c] for c in cells}
                sums = {c: gradients.fc_weight_sums(
                    layer, x2[c][:, self._cols(key, c)] if sharded else x2[c], y_out[c], g[c])
                    for c in cells}
                dW = self.coll.all_reduce({c: sums[c][0] for c in cells}, "data")
                col = self.coll.all_reduce({c: sums[c][1] for c in cells}, "data")
                for c in cells:
                    lg = grads[c][key]
                    lg["weights_gradient"] = optimizer.accumulate_gradient_2d(
                        gradients.wrap_i32(dW[c]), lg["weights_gradient"])
                    lg["c0_gradient"] = lg["c0_gradient"] + f32(gradients.wrap_i32(col[c]))
                if layer is not first:
                    d_in = {c: gradients.fc_input_grad(layer, y_out[c], params[c][key]["weights"],
                                                       g[c]) for c in cells}
                    if sharded:
                        d_in = self.coll.gather(d_in, "model", 1, self._rows[key])
                    g = {c: d_in[c].reshape(x_in[c].shape) if layer.flatten_input else d_in[c]
                         for c in cells}
            elif isinstance(layer, (Conv2DLayer, DepthwiseConv2DLayer)):
                dw = isinstance(layer, DepthwiseConv2DLayer)
                backward = (gradients.dwconv_backward_sample if dw
                            else gradients.conv_backward_sample)
                res = {c: backward(layer, x_in[c], y_out[c], params[c][key]["weights"], g[c],
                                   self._wzp[self.coll.device(c)][layer.index]) for c in cells}
                self._fold(key, grads, {c: res[c][0] for c in cells}, bound, batch)
                if dw:  # the conv bias update is disabled in the reference
                    part = self.coll.all_reduce(
                        {c: res[c][1].to(torch.float64).sum(0) for c in cells}, "data")
                    for c in cells:
                        grads[c][key]["c0_gradient"] = (grads[c][key]["c0_gradient"]
                                                        + part[c].to(torch.float32))
                g = {c: res[c][2] for c in cells}
            elif isinstance(layer, AveragePool2DLayer):
                g = {c: gradients.avgpool_backward_sample(layer, y_out[c], g[c]) for c in cells}
            elif isinstance(layer, ReshapeLayer):
                g = {c: g[c].reshape(x_in[c].shape) for c in cells}
        self._store(self.grads, grads)
        return loss_out

    # --- public API (TrainableModel's) ---

    def predict_quantized_train(self, xq, gt_q, learning_rate: float = 0.0) -> torch.Tensor:
        """Quantized input and ground truth (the global batch) -> the
        dequantized pre-loss output, the cells' rows in batch order, on the
        first cell's device.  Accumulates gradients on the shards."""
        m = self.model
        xq = torch.as_tensor(xq).to(torch_dtype(m.graph.input_dtype))
        gt_q = torch.as_tensor(gt_q).to(torch_dtype(m.graph.output_dtype))
        batch = xq.shape[0]
        self._batch_sizes = split_sizes(batch, self.mesh.shape["data"])
        xs = shard_batch(self.mesh, xq, self.cells).shards
        gts = shard_batch(self.mesh, gt_q, self.cells).shards
        bound = self._step_fold_bound()
        loss_out = self._train_step({c: xs[c] for c in self.cells},
                                    {c: gts[c] for c in self.cells}, bound, batch)
        self._advance_fold_bound(bound, batch)
        out = self.coll.gather(loss_out, "data", 0, self._batch_sizes)[self.cells[0]]
        layer = m.graph.layers[m.loss_index]
        return dequantize(out, layer.out_q.scale0, layer.out_q.zp0)

    def update_layers(self, batch_size: int, learning_rate: float) -> None:
        m, cells = self.model, self.cells
        params = {c: self._cell_tree(self.params, c) for c in cells}
        grads = {c: self._cell_tree(self.grads, c) for c in cells}
        for layer in m._backward_layers:
            key = f"layer{layer.index}"
            if key not in self.grads:
                continue
            new = {c: dict(params[c][key]) for c in cells}
            g = {c: grads[c][key] for c in cells}
            if isinstance(layer, FullyConnectedLayer):
                sharded = key in self._rows
                sq = {c: optimizer.clip_norm_squares(g[c]["weights_gradient"], batch_size)
                      for c in cells}
                if sharded:
                    sq = self.coll.all_reduce(sq, "model")
                for c in cells:
                    new[c]["weights"] = optimizer.clip_norm_step(
                        new[c]["weights"], g[c]["weights_gradient"], sq[c], batch_size,
                        learning_rate)
                col = {c: new[c]["weights"].to(torch.int64).sum(0) for c in cells}
                if sharded:
                    col = self.coll.all_reduce(col, "model")
                for c in cells:
                    new[c]["c2"] = optimizer.refold_c2(col[c], layer.in_q.zp0)
            else:
                for c in cells:
                    new[c]["weights"] = optimizer.update_weights_4d(
                        new[c]["weights"], g[c]["weights_gradient"], batch_size, learning_rate)
            for c in cells:
                new[c]["c0"] = optimizer.update_weights_2d_float(
                    new[c]["c0"], g[c]["c0_gradient"], batch_size, learning_rate)
                params[c][key] = new[c]
                grads[c][key] = {k: torch.zeros_like(v) for k, v in g[c].items()}
        self._store(self.params, params)
        self._store(self.grads, grads)
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
                    parts = self.coll.gather(parts, "model", 0, self._rows[key])
                out[key][name] = parts[self.cells[0]]
        return out
