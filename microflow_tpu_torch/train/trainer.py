"""TrainableModel: the generated-train-struct equivalent (reference T1,
``microflow-train-macros/src/lib.rs:53-270``), as
``microflow_tpu.train.trainer``, and the cells its step runs on.

``TrainableModel(graph, num_train_layers, loss, skip_last_layer_train)``
mirrors ``#[model(path, num_train_layers, loss, skip_last_layer_train)]``:
the last ``num_train_layers`` operators form the trainable suffix (the
frozen prefix runs plain inference); ``skip_last_layer_train`` excludes
the final operator (typically SOFTMAX) from backward/update while the
loss is computed on the tensor *before* it.

API parity:

* ``predict(x)`` / ``predict_quantized(x)``: inference;
* ``predict_train(x, gt_q, lr)``: forward + backward, accumulates integer
  gradients in ``grads`` (like the generated struct's
  ``weightsN_gradient`` fields), returns the dequantized pre-loss output;
* ``update_layers(batch_size, lr)``: clip-norm SGD on FC weights, plain
  SGD on conv/dwconv weights, an f32 step on the folded bias C0, the
  re-fold of FC's C2, the gradients zeroed.

The forward runs the model's backend: ``"xla"`` (the default, as in the
JAX package) or ``"pallas"``, the per-op kernels ``qgemm`` and
``qdwconv`` on CUDA.  The backward and the update are plain torch on the
model's device, but for the weight gradients of 1x1 convs, which the
``qwgrad`` kernel folds into their accumulators where ``fold_path`` picks
it.  The whole-network backends bake the weights into their kernels'
plans and so cannot train: asking for one raises.

The step's phases run on cells (``Cells``): cell ``(i, j)`` of a
``[n_data, n_model]`` mesh holds batch chunk ``i`` (contiguous, in batch
order), every replicated leaf and, of a row-sharded FC weight matrix and
its accumulator, rows ``j`` of K.  A TrainableModel is the one cell of a
``[1, 1]`` mesh; ``parallel.tp.ShardedTrainer`` runs the same phases on a
larger one.  The cells meet only in a ``Collectives`` over one axis, in
sums of integers or of float64 integers below 2**53, exact in any order,
so the step is bit-equal on every mesh; along an axis of one index a
collective returns what it was given, with no device work.

On CUDA the step's three phases replay as CUDA graphs (``graphs.py``)
from the second step at a key on; a CPU model, the serial saturating fold
and a fold bound read from the device run the eager code.  The model's
``params`` and ``grads`` are then copies made when first asked for (no
later step writes a tensor handed out), and a tree assigned or written
between steps is copied in before the next replay.  ``utils.trace``
counts each step that replayed all three phases
(``mft.train.graph_steps``) and each other one (``mft.train.eager_steps``),
and a step's conv layers by fold path (``mft.train.wgrad_folds``,
``mft.train.wgrad_plain``).
"""

from __future__ import annotations

from collections import Counter
from types import SimpleNamespace

import numpy as np
import torch

from ..compiler.builder import (
    BAKED_BACKENDS,
    CompiledModel,
    _bias0,
    apply_layer,
    layer_constants,
    params_from_numpy,
    resolve_device,
    select_backend,
)
from ..compiler.ir import (
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    Graph,
    ReshapeLayer,
    SoftmaxLayer,
    refuse_wiring,
)
from ..core.numerics import as_device, const_f32, f32, read_host, torch_dtype
from ..core.quantize import dequantize, quantize
from ..core.tensor import reshape_2d
from ..kernels import qwgrad
from ..ops.fully_connected import fc_partial, fc_requant
from ..utils import trace
from . import gradients, graphs, losses, optimizer

AXIS = {"data": 0, "model": 1}
CELL = (0, 0)  # a TrainableModel's own step runs on one cell
# the ways a conv or depthwise layer's per-sample weight gradients reach
# its accumulator (``fold_path``)
KERNEL, SUM, SERIAL = "qwgrad", "sum", "serial"


def grads_from_numpy(grads: dict, device=None) -> dict:
    """``{"layerN": {"weights_gradient", "c0_gradient"}}`` of numpy arrays
    (or anything ``np.asarray`` takes, such as the JAX package's
    ``TrainableModel.grads``) -> the same dict of tensors on ``device``."""
    return params_from_numpy(grads, device)


def grads_to_numpy(grads: dict) -> dict:
    """The gradient state as numpy arrays on the host."""
    return {layer: {k: v.cpu().numpy() for k, v in arrays.items()}
            for layer, arrays in grads.items()}


class Collectives:
    """Sums over one axis of ``mesh`` (a ``parallel.Mesh``, or anything with
    its ``devices`` grid) among the cells of this process (``cells``: here
    every cell).  ``parts`` maps a cell ``(data, model)`` to its tensor;
    each method returns such a map over ``cells``, each cell's tensor on
    that cell's device (cells of one device may share one), and along an
    axis of one index the tensors it was given."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.cells = list(np.ndindex(*mesh.devices.shape))

    def device(self, cell) -> torch.device:
        return self.mesh.devices[cell]

    def size(self, axis: str) -> int:
        """The indices of ``axis`` on the mesh (this process may hold fewer)."""
        return self.mesh.devices.shape[AXIS[axis]]

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
        if self.size(axis) == 1:
            return {c: parts[c] for c in self.cells}
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
        if self.size(axis) == 1:
            return {c: parts[c] for c in self.cells}
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
        if self.size(axis) == 1:
            return {c: parts[c] for c in self.cells}
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


class Cells:
    """This process's cells of a step (``cells``), the ``Collectives`` they
    meet through (``coll``), each cell's per-op constants (``consts``) and
    conv weight zero points (``wzp``), from ``tables``' by device, and each
    row-sharded FC's rows of K on each ``model`` index (``rows``)."""

    def __init__(self, coll: Collectives, tables: dict, rows: dict | None = None):
        self.coll, self.cells, self.rows = coll, coll.cells, rows or {}
        self.consts = {c: tables[coll.device(c)][0] for c in self.cells}
        self.wzp = {c: tables[coll.device(c)][1] for c in self.cells}

    def cols(self, x: torch.Tensor, key: str, cell) -> torch.Tensor:
        """The columns of the FC ``key``'s input ``x`` for ``cell``'s rows."""
        return torch.tensor_split(x, len(self.rows[key]), dim=1)[cell[1]]

    def run(self, program) -> dict:
        """Every cell's ``program(cell)``, a generator, run to its end in
        step: each yields ``(name, tensor, *args)`` where the cells meet,
        and is sent its cell's part of ``coll.<name>`` of every cell's
        tensor.  What each program returned, by cell."""
        programs = {c: program(c) for c in self.cells}
        sent = dict.fromkeys(programs)
        while True:
            asks, done = {}, {}
            for c, prog in programs.items():
                try:
                    asks[c] = prog.send(sent[c])
                except StopIteration as end:
                    done[c] = end.value
            if done:
                if asks:
                    raise RuntimeError(f"cells {sorted(asks)} meet where {sorted(done)} ended")
                return done
            name, _, *args = asks[self.cells[0]]
            sent = getattr(self.coll, name)({c: ask[1] for c, ask in asks.items()}, *args)


def fold_path(layer, x_q: torch.Tensor, gradient_mode: str, bound, batch: int,
              n_data: int) -> str:
    """How a step folds ``layer``'s per-sample weight gradients into its
    accumulator: by the ``qwgrad`` kernel (``KERNEL``) where the mesh's
    ``data`` axis has one index and ``qwgrad.takes_kernel`` holds for the
    cell's batch ``x_q``; by an int64 sum over ``data`` (``SUM``) where it
    has more and the fold of the global ``batch`` under the host ``bound``
    is the plain sum; else (``SERIAL``) by the fold of record,
    ``optimizer.accumulate_gradient_4d_fold``, of the batch in order."""
    if n_data == 1:
        return KERNEL if qwgrad.takes_kernel(layer, x_q, gradient_mode, bound) else SERIAL
    return SUM if bound is not None and optimizer.fold_is_plain_sum(bound, batch) else SERIAL


class FoldBound:
    """C1's host-side bound on the conv/dw weight-gradient accumulators
    (``_accumulators()``, which the trainer defines), shared by
    ``TrainableModel`` and ``parallel.tp.ShardedTrainer``: the accumulators
    start at 0 and a step of B samples moves each entry by at most
    ``optimizer.fold_margin(B)``; while the bound plus a step's margin stays
    within i32, the saturating fold is the plain sum, with no device read.
    The bound holds for the accumulator tensors it was set on, at their
    version counts then (``_fold_seen``); an accumulator replaced or
    changed in place since (``grads`` assigned, an entry of it replaced, or
    written to) has it read from the tensors at the next step."""

    def _set_fold_bound(self, bound: int | None) -> None:
        self._fold_bound = bound
        self._fold_seen = [(acc, acc._version) for acc in self._accumulators()]

    def _fold_bound_holds(self) -> bool:
        """Whether ``_fold_bound`` was set on the accumulators as they are
        now: the same tensors, none written to since."""
        return self._fold_bound is not None and all(
            acc is seen and acc._version == version
            for acc, (seen, version) in zip(self._accumulators(), self._fold_seen))

    def _accumulator_bound(self) -> int:
        """The largest |entry| of the accumulators (a device read)."""
        return max((int(read_host(acc.to(torch.int64).abs().max()))
                    for acc in self._accumulators()), default=0)

    def _advance_fold_bound(self, bound: int, batch: int) -> None:
        """The bound after a step of ``batch`` samples that started at
        ``bound``; entries never pass |INT_MIN|."""
        self._set_fold_bound(min(bound + optimizer.fold_margin(batch), 2**31))


class TrainableModel(FoldBound, CompiledModel):
    def __init__(
        self,
        graph: Graph,
        num_train_layers: int,
        loss: str = "mse",
        skip_last_layer_train: bool = False,
        backend: str | None = None,
        gradient_mode: str = "quantized",
        device=None,
    ):
        refuse_wiring(graph, "training")
        device = resolve_device(device)
        resolved = select_backend(graph, backend or "xla", device.type)[0]
        if resolved in BAKED_BACKENDS:
            raise ValueError(
                f"backend {resolved!r} bakes the weights into its kernel's plan and cannot "
                "train; a TrainableModel runs 'xla' or 'pallas'")
        super().__init__(graph, backend=resolved, device=device)
        if loss not in ("mse", "crossentropy"):
            raise NotImplementedError(f"loss {loss!r}")
        self.loss = loss
        n = len(graph.layers)
        self.train_indices = [layer.index for layer in graph.layers[n - num_train_layers:]]
        self.backward_indices = list(self.train_indices)
        if skip_last_layer_train and self.backward_indices:
            self.backward_indices = self.backward_indices[:-1]
        # the loss reads the output of the last *backward* layer (lib.rs:209-215)
        self.loss_index = self.backward_indices[-1] if self.backward_indices else None
        # gradient_mode="float": the JAX package's end-to-end run of the
        # reference's "unquantized" f32 gradient twins
        # (gradient_fully_connected.rs:118-152, :198-232, :268-299), which
        # exist for FC only
        if gradient_mode not in ("quantized", "float"):
            raise ValueError(f"gradient_mode {gradient_mode!r}")
        self.gradient_mode = gradient_mode
        if gradient_mode == "float":
            for i in self.backward_indices:
                if not isinstance(graph.layers[i],
                                  (FullyConnectedLayer, ReshapeLayer, SoftmaxLayer)):
                    raise NotImplementedError(
                        "gradient_mode='float' covers FC suffixes only (the reference's "
                        "unquantized twins exist only for FC, gradient_fully_connected.rs:"
                        f"118-299); layer {i} is {type(graph.layers[i]).__name__}")
        self._backward_layers = [graph.layers[i] for i in self.backward_indices]
        # per-channel weight zero points of the conv layers, on the device once
        self._wzp = {layer.index: layer_constants(layer, self.device)["wzp"]
                     for layer in self._backward_layers
                     if isinstance(layer, (Conv2DLayer, DepthwiseConv2DLayer))}
        self._cells = Cells(Collectives(SimpleNamespace(devices=np.full((1, 1), self.device,
                                                                        dtype=object))),
                            {self.device: (self._consts, self._wzp)})
        # the fold's host bound (``FoldBound``) starts at 0 with the
        # accumulators
        self._grads = self._init_grads()
        self._set_fold_bound(0)
        # the CUDA graphs of the step (``graphs.py``), made as steps come:
        # the trees they read and write; a step key's WARM, FAILED or (input
        # buffer, label buffer, forward, backward); an update key's WARM,
        # FAILED or graph
        self._static = graphs.StaticTrees()
        self._step_graphs: dict = {}
        self._update_graphs: dict = {}
        # the span of the train step under way: from predict_quantized_train
        # to the end of update_layers, how many of its phases replayed, and
        # its conv layers by fold path, counted when it ends
        self._step = None
        self._replayed = 0
        self._step_paths = Counter()

    # --- state: the model's own trees, or the graphs' static ones ---

    @property
    def params(self) -> dict:
        if self._params is None:  # the last update replayed into the static tree
            self._params = self._static.hand_out("params")
        return self._params

    @params.setter
    def params(self, params: dict) -> None:
        self._params = params

    @property
    def grads(self) -> dict:
        if self._grads is None:  # the last phase replayed into the static tree
            holds = self._fold_bound_holds()
            self._grads = self._static.hand_out("grads")
            if holds:  # the copies are the accumulators now
                self._set_fold_bound(self._fold_bound)
        return self._grads

    @grads.setter
    def grads(self, grads: dict) -> None:
        self._grads = grads
        self._fold_bound = None

    def _accumulators(self) -> list[torch.Tensor]:
        """The conv/dw weight-gradient accumulators, which the fold's bound
        covers."""
        grads = self._grads if self._grads is not None else self._static.trees["grads"]
        return [grads[f"layer{i}"]["weights_gradient"] for i in self._wzp]

    def _init_grads(self) -> dict:
        """Zero accumulators of each backward layer with weights (FC, conv,
        depthwise): i32 weight gradients (f32 in the float mode, which
        trains FC only) and f32 C0 gradients."""
        wg_dtype = torch.float32 if self.gradient_mode == "float" else torch.int32
        return {key: {"weights_gradient": torch.zeros_like(p["weights"], dtype=wg_dtype),
                      "c0_gradient": torch.zeros_like(p["c0"], dtype=torch.float32)}
                for key, p in ((f"layer{layer.index}", self.params.get(f"layer{layer.index}"))
                               for layer in self._backward_layers) if p is not None}

    # --- the step's phases: each the program of one cell ``c`` of ``on``
    # (``Cells.run``), on the cell's trees and rows of the batch; ``sizes``:
    # the batch's rows on each ``data`` index ---

    def _forward_phase(self, on: Cells, c, params: dict, x: torch.Tensor, sizes: list[int]):
        """The forward, saving (input, output) of every backward layer, and
        the loss layer's output, every cell's rows gathered in batch order,
        dequantized: (acts, output)."""
        acts, keep = {}, set(self.backward_indices)
        for layer in self.graph.layers:
            key = f"layer{layer.index}"
            if key in on.rows:
                # a row-sharded FC: the products over the cell's rows of K
                # summed over ``model``, then the epilogue; the plain integer
                # product on every backend, as the JAX package's XLA one
                p = params[key]
                x2 = reshape_2d(x) if layer.flatten_input else x
                total = yield "all_reduce", fc_partial(on.cols(x2, key, c), p["weights"],
                                                       w_zp=layer.w_q.zp0), "model"
                y = fc_requant(total, bias0=_bias0(layer, p), c1=layer.c1, c2=p["c2"],
                               c3=layer.c3, out_scale=layer.out_q.scale0,
                               out_zp=layer.out_q.zp0, activation=layer.activation,
                               out_dtype=x.dtype)
            else:
                y = apply_layer(layer, params, x, self.backend, on.consts[c].get(layer.index))
            if layer.index in keep:
                acts[layer.index] = (x, y)
            x = y
        loss_layer = self.graph.layers[self.loss_index]
        out = yield "gather", acts[self.loss_index][1], "data", 0, sizes
        return acts, dequantize(out, loss_layer.out_q.scale0, loss_layer.out_q.zp0)

    def _backward_phase(self, on: Cells, c, params: dict, acts: dict, gt_q: torch.Tensor,
                        grads: dict, bound: int, sizes: list[int]):
        """The loss gradient and every backward layer's, folded into the
        accumulators: the new grads tree (a leaf no layer changed stays the
        tensor it was), and the conv layers by fold path (``trace.WGRAD_*``)."""
        graph = self.graph
        loss_layer = graph.layers[self.loss_index]
        loss_out = acts[self.loss_index][1]

        # initial backward gradient from the loss (T9)
        if self.loss == "mse":
            g = losses.mse_grad(loss_out, gt_q)
        else:
            g = losses.crossentropy_grad(loss_out, graph.output_q.scale0, graph.output_q.zp0,
                                         gt_q, in_scale=loss_layer.out_q.scale0)
        if self.gradient_mode == "float":
            # both losses' quantized gradients are deltas on the loss
            # tensor's grid: its step size makes the exact f32 counterpart
            g = const_f32(loss_layer.out_q.scale0, g.device) * f32(g)

        # backward in reverse layer order (T1's token prepending)
        grads = {k: dict(v) for k, v in grads.items()}
        paths = Counter()
        for layer in reversed(self._backward_layers):
            key = f"layer{layer.index}"
            lg = grads.get(key)
            x_in, y_out = acts[layer.index]
            if isinstance(layer, FullyConnectedLayer):
                with trace.Span("mft.train.backward.fc"):
                    x2 = reshape_2d(x_in) if layer.flatten_input else x_in
                    weights = params[key]["weights"]
                    if self.gradient_mode == "float":  # one cell: ShardedTrainer refuses it
                        dW, bias_grad, g = gradients.fc_backward_float(layer, x2, y_out, weights,
                                                                       g)
                        # plain f32 accumulation (the twin of accumulate_gradient_2D)
                        lg["weights_gradient"] = lg["weights_gradient"] + dW
                        lg["c0_gradient"] = lg["c0_gradient"] + bias_grad
                    else:
                        # the exact sums, over the cell's columns of x where W
                        # is row-sharded, summed over ``data`` before the wrap
                        sharded = key in on.rows
                        dW, col = gradients.fc_weight_sums(
                            layer, on.cols(x2, key, c) if sharded else x2, y_out, g)
                        dW = yield "all_reduce", dW, "data"
                        col = yield "all_reduce", col, "data"
                        lg["weights_gradient"] = optimizer.accumulate_gradient_2d(
                            gradients.wrap_i32(dW), lg["weights_gradient"])
                        lg["c0_gradient"] = lg["c0_gradient"] + f32(gradients.wrap_i32(col))
                        g = gradients.fc_input_grad(layer, y_out, weights, g)
                        if sharded:  # the cell's columns of dIn
                            g = yield "gather", g, "model", 1, on.rows[key]
                    if layer.flatten_input:
                        g = g.reshape(x_in.shape)
            elif isinstance(layer, (Conv2DLayer, DepthwiseConv2DLayer)):
                conv = isinstance(layer, Conv2DLayer)
                with trace.Span("mft.train.backward.conv" if conv else "mft.train.backward.dwconv"):
                    # the conv bias update is disabled in the reference
                    # (gradient_conv_2d.rs:63 commented out): its gradient
                    # goes unused
                    weights, wzp = params[key]["weights"], on.wzp[c][layer.index]
                    path = fold_path(layer, x_in, self.gradient_mode, bound, sum(sizes),
                                     on.coll.size("data"))
                    if conv:
                        paths[trace.WGRAD_FOLDS if path == KERNEL else trace.WGRAD_PLAIN] += 1
                    if path == KERNEL:
                        md = gradients.mask_d_out(layer, y_out, g)
                        with trace.Span("mft.train.fold"):
                            lg["weights_gradient"] = qwgrad.qwgrad(
                                layer, x_in, md, lg["weights_gradient"])
                        g = gradients.conv_input_grad(layer, md, weights, wzp)
                        continue
                    backward = (gradients.conv_backward_sample if conv
                                else gradients.dwconv_backward_sample)
                    dW_b, bias_b, g = backward(layer, x_in, y_out, weights, g, wzp)
                    with trace.Span("mft.train.fold"):
                        acc = lg["weights_gradient"]
                        if path == SUM:
                            total = yield "all_reduce", dW_b.to(torch.int64).sum(0), "data"
                            acc = (acc.to(torch.int64) + total).to(torch.int32)
                        else:
                            # per-sample saturating accumulation, not
                            # associative: every cell's gradients in batch
                            # order, folded on the first ``data`` cell
                            full = yield "gather", dW_b, "data", 0, sizes
                            acc = (optimizer.accumulate_gradient_4d_fold(full, acc, bound)
                                   if c[0] == 0 else None)
                            acc = yield "broadcast", acc, "data"
                        lg["weights_gradient"] = acc
                    if not conv:  # float64 sums over ``data``, rounded to f32 once
                        c0 = yield "all_reduce", bias_b.to(torch.float64).sum(0), "data"
                        lg["c0_gradient"] = lg["c0_gradient"] + c0.to(torch.float32)
            elif isinstance(layer, AveragePool2DLayer):
                with trace.Span("mft.train.backward.pool"):
                    g = gradients.avgpool_backward_sample(layer, y_out, g)
            elif isinstance(layer, ReshapeLayer):
                g = g.reshape(x_in.shape)  # T8: reshape the gradient
            # softmax: forward-only even in train mode (T7)
        return grads, paths

    def _updated_keys(self, grads: dict) -> list[str]:
        """The layers an update changes: the backward layers with
        accumulators."""
        return [key for key in (f"layer{layer.index}" for layer in self._backward_layers)
                if key in grads]

    def _update_phase(self, on: Cells, c, params: dict, grads: dict, batch_size: int,
                      lr: float):
        """The params tree after the update of ``_updated_keys(grads)``; the
        caller zeroes their accumulators."""
        params = dict(params)
        for layer in self._backward_layers:
            key = f"layer{layer.index}"
            if key not in grads:
                continue
            p, g = dict(params[key]), grads[key]
            if isinstance(layer, FullyConnectedLayer):
                sharded = key in on.rows
                if self.gradient_mode == "float":
                    p["weights"] = optimizer.update_weights_2d_from_float(
                        p["weights"], g["weights_gradient"], layer.w_q.scale0, batch_size, lr)
                else:  # the clip norm of the whole matrix
                    squares = optimizer.clip_norm_squares(g["weights_gradient"], batch_size)
                    if sharded:
                        squares = yield "all_reduce", squares, "model"
                    p["weights"] = optimizer.clip_norm_step(
                        p["weights"], g["weights_gradient"], squares, batch_size, lr)
                # C2 refolded from the column sums of all of W's rows
                col = p["weights"].to(torch.int64).sum(0)
                if sharded:
                    col = yield "all_reduce", col, "model"
                p["c2"] = optimizer.refold_c2(col, layer.in_q.zp0)
            else:
                p["weights"] = optimizer.update_weights_4d(
                    p["weights"], g["weights_gradient"], batch_size, lr)
            p["c0"] = optimizer.update_weights_2d_float(p["c0"], g["c0_gradient"], batch_size, lr)
            params[key] = p
        return params

    # --- the step: eager, or replayed ---

    def _run(self, phase, *args):
        """``phase`` run on the model's one cell."""
        return self._cells.run(lambda c: phase(self._cells, c, *args))[CELL]

    def _sync_static(self) -> bool:
        """Copy the model's own trees, where it holds them, into the static
        ones; False where they no longer fit them."""
        static = self._static
        return ((self._params is None or static.sync("params", self._params))
                and (self._grads is None or static.sync("grads", self._grads)))

    def _capture_step(self, xq: torch.Tensor, gt_q: torch.Tensor, bound: int):
        """The forward and backward graphs of ``xq``'s and ``gt_q``'s key,
        with their input and label buffers, in one memory pool (they always
        replay in the order they were captured)."""
        trees = self._static.trees
        params, grads = trees["params"], trees["grads"]
        x = torch.empty(xq.shape, dtype=xq.dtype, device=xq.device)
        gt = torch.empty(gt_q.shape, dtype=gt_q.dtype, device=gt_q.device)
        pool = torch.cuda.graph_pool_handle()
        sizes = [x.shape[0]]
        forward = graphs.capture("forward", lambda: self._run(self._forward_phase, params, x,
                                                              sizes), pool)
        if forward is graphs.FAILED:
            return forward

        def backward():  # its output: the conv layers by fold path
            new, paths = self._run(self._backward_phase, params, forward.out[0], gt, grads,
                                   bound, sizes)
            graphs.copy_tree(grads, new)
            return paths

        backward = graphs.capture("backward", backward, pool)
        if backward is graphs.FAILED:
            return backward
        return x, gt, forward, backward

    def _graphs(self, table: dict, key, capture):
        """The graphs of ``key`` in ``table``, captured by ``capture()`` at
        its second step, the static trees synced; None where the phases run
        eager (the key is None, new, or failed to capture; or the trees no
        longer fit)."""
        if key is None:
            return None
        entry = table.get(key)
        if entry is None:
            table[key] = graphs.WARM
            return None
        if entry is graphs.FAILED or not self._sync_static():
            return None
        if entry is graphs.WARM:
            entry = table[key] = capture()
        return None if entry is graphs.FAILED else entry

    def _replayed_step(self, xq: torch.Tensor, gt_q: torch.Tensor, bound: int | None):
        """The step's forward and backward replayed, and the output; None
        where the step runs the eager code."""
        entry = self._graphs(self._step_graphs,
                             graphs.step_key(self.device, xq, gt_q, self.gradient_mode, bound),
                             lambda: self._capture_step(xq, gt_q, bound))
        if entry is None:
            return None
        x, gt, forward, backward = entry
        with trace.Span("mft.train.forward"):
            x.copy_(xq)
            out = forward.replay()[1]
        with trace.Span("mft.train.backward"):
            gt.copy_(gt_q)
            self._step_paths = backward.replay()
        self._grads = None
        self._replayed = 2
        return out.clone()

    def _eager_step(self, xq: torch.Tensor, gt_q: torch.Tensor, bound: int) -> torch.Tensor:
        params, sizes = self.params, [xq.shape[0]]
        with trace.Span("mft.train.forward"):
            acts, out = self._run(self._forward_phase, params, xq, sizes)
        with trace.Span("mft.train.backward"):
            self._grads, self._step_paths = self._run(self._backward_phase, params, acts, gt_q,
                                                      self.grads, bound, sizes)
        return out

    def _capture_update(self, batch_size: int, lr: float):
        """The update's graph at ``batch_size`` and ``lr``."""
        trees = self._static.trees
        params, grads = trees["params"], trees["grads"]

        def update():
            graphs.copy_tree(params, self._run(self._update_phase, params, grads, batch_size, lr))
            for key in self._updated_keys(grads):
                for t in grads[key].values():
                    t.zero_()

        return graphs.capture("update", update, torch.cuda.graph_pool_handle())

    def _replayed_update(self, batch_size: int, lr: float) -> bool:
        """The update replayed; False where it runs the eager code."""
        entry = self._graphs(self._update_graphs, graphs.update_key(self.device, batch_size, lr),
                             lambda: self._capture_update(batch_size, lr))
        if entry is None:
            return False
        entry.replay()
        self._params = self._grads = None
        self._replayed += 1
        return True

    def _eager_update(self, batch_size: int, lr: float) -> None:
        grads = self.grads
        self.params = self._run(self._update_phase, self.params, grads, batch_size, lr)
        self._grads = {**grads, **{key: {k: torch.zeros_like(v) for k, v in grads[key].items()}
                                   for key in self._updated_keys(grads)}}

    # --- public API (mirrors the generated train struct) ---

    def predict_train(self, x, gt_q, learning_rate: float = 0.0) -> torch.Tensor:
        """f32 input + quantized ground truth -> dequantized pre-loss
        output.  Accumulates gradients on the object (like the generated
        struct's mutable fields)."""
        return self.predict_quantized_train(self.quantize_input(x), gt_q, learning_rate)

    def predict_quantized_train(self, xq, gt_q, learning_rate: float = 0.0) -> torch.Tensor:
        self._end_step()  # a step whose update never came ends here
        step = self._step = trace.Span("mft.train.step", root=True).open()
        try:
            xq = self._input(xq, torch_dtype(self.graph.input_dtype))
            gt_q = self._input(gt_q, torch_dtype(self.graph.output_dtype))
            with trace.Span("mft.train.fold"):
                on_host = self._fold_bound_holds()
                bound = self._fold_bound if on_host else self._accumulator_bound()
            out = self._replayed_step(xq, gt_q, bound if on_host else None)
            if out is None:
                out = self._eager_step(xq, gt_q, bound)
            self._advance_fold_bound(bound, xq.shape[0])
            return out
        except BaseException:
            self._end_step()
            raise
        finally:
            step.suspend()  # until update_layers

    def update_layers(self, batch_size: int, learning_rate: float) -> None:
        if self._step is not None:
            self._step.resume()
        try:
            with trace.Span("mft.train.update"):
                if not self._replayed_update(batch_size, learning_rate):
                    self._eager_update(batch_size, learning_rate)
            self._set_fold_bound(0)  # accumulators zeroed (update_ops semantics)
        finally:
            self._end_step()

    def _end_step(self) -> None:
        """Close the span of the train step under way, if one is, counting
        it as a graph step (all three phases replayed) or an eager one."""
        step, self._step = self._step, None
        if step is not None:
            trace.count(trace.GRAPH_STEPS if self._replayed == 3 else trace.EAGER_STEPS)
            for name, n in self._step_paths.items():
                trace.count(name, n)
            self._replayed, self._step_paths = 0, Counter()
            step.close()

    def quantize_target(self, y) -> torch.Tensor:
        """Quantize a float target with the loss tensor's output params
        (the examples do this by hand, ``sine_train.rs:41-46``)."""
        layer = self.graph.layers[self.loss_index]
        y = as_device(y, self.device, torch.float32)
        return quantize(y, layer.out_q.scale0, layer.out_q.zp0,
                        dtype=torch_dtype(self.graph.output_dtype))


def compile_tflite_train(
    path: str,
    num_train_layers: int,
    loss: str = "mse",
    skip_last_layer_train: bool = False,
    name: str | None = None,
    backend: str | None = None,
    gradient_mode: str = "quantized",
    device=None,
) -> TrainableModel:
    """Front door mirroring ``#[model(path, n, loss, skip)]``, on ``device``
    (default CUDA; raises if CUDA is absent)."""
    from ..frontend.parser import parse

    device = resolve_device(device)
    return TrainableModel(parse(path, name=name), num_train_layers, loss, skip_last_layer_train,
                          backend=backend, gradient_mode=gradient_mode, device=device)
