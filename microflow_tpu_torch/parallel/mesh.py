"""Device mesh and placement helpers: the port of
``microflow_tpu.parallel.mesh``.

The JAX package is single-controller: one process drives every device of
its mesh, and so does the port.  A ``Mesh`` here is a grid of this
process's ``torch.device``s, ``[n_data, n_model]``:

* ``data`` axis: the batch is split across it (data parallelism).
  Inference is embarrassingly parallel over the batch: each ``data``
  index runs its own replica of the model on its chunk, with no
  collective.
* ``model`` axis: placement of the widest FC weights as row shards
  (``shard_params``), which the tensor-parallel train step
  (``parallel/tp.py``) computes from.

Placement is recorded with the JAX package's partition specs as tuples
(``("model", None)`` for a row-sharded leaf, ``()`` for a replicated one),
so a placement can be compared with a JAX ``PartitionSpec``.
Across processes (``parallel/distributed.py``) a mesh is the same grid, of
which each process holds some cells: placement then fills only those
(``cells``), and the other entries of ``shards`` are None.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

AXES = ("data", "model")


def canonical(device) -> torch.device:
    """``device`` with the index that CUDA tensors report (``"cuda"`` ->
    ``cuda:<current>``), so devices compare equal to tensors' ``.device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def mesh_devices(min_devices: int = 1) -> list[torch.device]:
    """Every CUDA device of this process.  Raises ``RuntimeError`` when
    there are fewer than ``min_devices``: the port never falls back to the
    CPU (the JAX package's ``mesh_devices`` falls back to its virtual CPU
    devices).  A CPU mesh exists only where the caller passes CPU devices
    to ``make_mesh``."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < min_devices:
        raise RuntimeError(
            f"a mesh of {min_devices} devices needs {min_devices} CUDA devices; this process "
            f"has {n} (pass devices=[torch.device('cpu')] * k to make_mesh for a CPU mesh)")
    return [torch.device("cuda", i) for i in range(n)]


class Mesh:
    """``devices``: an object array ``[n_data, n_model]`` of
    ``torch.device``; ``axis_names`` ``("data", "model")``; ``shape``
    ``{"data": n_data, "model": n_model}``, as the JAX ``Mesh`` has them."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or not devices.size:
            raise ValueError(f"mesh devices must be a non-empty [n_data, n_model] grid, "
                             f"not {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_devices(self) -> list[torch.device]:
        """The device of each ``data`` index: the one that runs its chunk."""
        return list(self.devices[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices.tolist()})"


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None) -> Mesh:
    """A ``[n_data, n_model]`` mesh of the first ``n_data * n_model`` of
    ``devices`` (default: ``mesh_devices``, every CUDA device; ``n_data``
    default: as many as the devices fill)."""
    if devices is None:
        devices = mesh_devices(min_devices=(n_data or 1) * n_model)
    devices = [canonical(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devices):
        raise ValueError(f"a [{n_data}, {n_model}] mesh needs {n_data * n_model} devices; "
                         f"{len(devices)} given")
    grid = np.empty(n_data * n_model, dtype=object)
    grid[:] = devices[: n_data * n_model]
    return Mesh(grid.reshape(n_data, n_model))


@dataclass
class Placed:
    """One tensor placed on a mesh: ``spec`` names the mesh axis each dim is
    split over (the JAX ``PartitionSpec`` as a tuple; ``()`` replicates), and
    ``shards[i, j]`` is the piece on ``mesh.devices[i, j]``."""

    spec: tuple
    shards: np.ndarray


def _place(mesh: Mesh, x: torch.Tensor, spec: tuple, cells=None) -> Placed:
    """Split ``x`` along each dim that ``spec`` names an axis for, into one
    contiguous piece per index of that axis, and copy each piece to the
    devices of its index (replicated over the other axis); only to the
    ``(data, model)`` cells listed in ``cells`` where given."""
    spec = tuple(spec)
    n = mesh.shape
    shards = np.empty(mesh.devices.shape, dtype=object)
    for i, j in (np.ndindex(*shards.shape) if cells is None else cells):
        index = {"data": i, "model": j}
        piece = x
        for dim, axis in enumerate(spec):
            if axis is not None:
                piece = torch.tensor_split(piece, n[axis], dim=dim)[index[axis]]
        shards[i, j] = piece.to(mesh.devices[i, j])
    return Placed(spec, shards)


def batch_spec(ndim: int) -> tuple:
    """The spec of a batch: dim 0 over the ``data`` axis, the rest whole
    (the JAX package's ``batch_sharding``)."""
    return ("data",) + (None,) * (ndim - 1)


def shard_batch(mesh: Mesh, x, cells=None) -> Placed:
    """``x`` split along dim 0 into one contiguous chunk per ``data``
    index; ``shards[i, j]`` is chunk ``i``, on ``mesh.devices[i, j]``."""
    x = torch.as_tensor(x)
    return _place(mesh, x, batch_spec(x.ndim), cells)


def replicate_params(mesh: Mesh, params: dict) -> dict:
    """A copy of ``params`` (``{layer: {name: tensor}}``) on each device of
    the mesh: ``{device: params}``.  A device listed more than once gets
    one copy, and tensors already on a device are not copied."""
    return {d: {k: {n: t.to(d) for n, t in sub.items()} for k, sub in params.items()}
            for d in dict.fromkeys(mesh.devices.flat)}


def tp_spec(name: str, arr, n_model: int, min_rows: int) -> tuple:
    """Default tensor-parallel policy, the JAX package's: shard 2D FC weight
    matrices (and their i32 gradient accumulators, which must follow the
    same layout) along the contraction dim (axis 0: weights are stored (in,
    out)) over the ``model`` axis; replicate the rest."""
    if (
        name in ("weights", "weights_gradient")
        and getattr(arr, "ndim", 0) == 2
        and arr.shape[0] % n_model == 0
        and arr.shape[0] >= min_rows
    ):
        return ("model", None)
    return ()


def shard_params(mesh: Mesh, tree: dict, policy="tp", min_rows: int | None = None,
                 cells=None) -> dict:
    """Place a params/grads tree (``{layer: {name: tensor}}``) on ``mesh``:
    ``{layer: {name: Placed}}``, on every cell or on the ``(data, model)``
    cells listed in ``cells``.

    ``policy``:
      * ``"replicate"``: every leaf whole on every device;
      * ``"tp"``: ``tp_spec`` on every leaf: big 2D FC weights and their
        gradient accumulators as row shards over the ``model`` axis (the
        shards of one ``data`` index concatenate back to the leaf), every
        other leaf replicated; everything replicated when the ``model``
        axis has size 1;
      * a callable ``(layer_key, name, arr) -> spec | None``; None
        replicates.
    """
    n_model = mesh.shape["model"]
    if min_rows is None:
        min_rows = 2 * n_model

    def spec_for(key, name, arr):
        if callable(policy):
            s = policy(key, name, arr)
            return () if s is None else tuple(s)
        if policy == "replicate" or n_model <= 1:
            return ()
        if policy == "tp":
            return tp_spec(name, arr, n_model, min_rows)
        raise ValueError(f"unknown sharding policy: {policy!r}")

    return {key: {name: _place(mesh, torch.as_tensor(arr), spec_for(key, name, arr), cells)
                  for name, arr in sub.items()}
            for key, sub in tree.items()}
