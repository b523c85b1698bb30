"""The multi-process tier: a mesh whose ``model`` axis spans the processes of
a ``torch.distributed`` group, and the collectives that let
``parallel/tp.py``'s sharded train step run on it (the port of the JAX
package's ``jax.distributed`` tier, ``scripts/multiprocess_worker.py``).

Rank ``r`` of ``world_size`` holds column ``r`` of a ``[n_data,
world_size]`` mesh: its own ``n_data`` devices, cell ``(i, r)`` on its
device ``i``, as the JAX worker pairs device ``i`` of each process in
column ``i`` (``scripts/multiprocess_worker.py:69-71``).  The ``data``
axis then lies within each process and reduces there; the ``model`` axis
reduces over the group, with ``all_reduce`` and ``broadcast`` only: gloo
supports nothing else on CUDA tensors, so gloo (CPU or CUDA tensors) and
NCCL run the same code.

The caller names the backend; nothing picks one from the machine.  NCCL
needs a CUDA device a rank (``init`` raises with fewer); two ranks on one
card run gloo, which reduces CUDA tensors through the host.  Rendezvous is
the caller's ``init_method``: ``file://<path>`` (no port to race for) or
``tcp://localhost:<port>``.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, canonical
from ..train.trainer import Collectives

BACKENDS = ("gloo", "nccl")
TIMEOUT = datetime.timedelta(seconds=120)  # of a collective and of the rendezvous


def init(init_method: str, world_size: int, rank: int, backend: str) -> None:
    """Join the process group: ``torch.distributed.init_process_group``
    with ``backend`` (``"gloo"`` or ``"nccl"``, named by the caller).  NCCL
    with fewer CUDA devices on this host than ranks on it raises
    ``RuntimeError``; it never falls back to gloo.  The ranks on this host
    are ``LOCAL_WORLD_SIZE`` where the launcher sets it (``torchrun``), else
    all ``world_size``, and this rank's card is ``LOCAL_RANK`` (else
    ``rank``) modulo the cards."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: choose one of {BACKENDS}")
    if backend == "nccl":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        if n < local:
            raise RuntimeError(
                f"NCCL needs a CUDA device a rank: {local} ranks on this host, {n} CUDA "
                "device(s) (NCCL cannot put two ranks on one device; run them with "
                "backend='gloo')")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % n)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=TIMEOUT)


def process_mesh(devices, world_size: int, rank: int) -> tuple[Mesh, list]:
    """The global ``[len(devices), world_size]`` mesh of which this rank
    holds column ``rank`` (its ``devices``, one a ``data`` index), and those
    cells.  Every rank passes as many devices; the other columns' entries
    stand for the other ranks' devices, which this process does not
    address."""
    devices = [canonical(d) for d in devices]
    grid = np.empty((len(devices), world_size), dtype=object)
    for j in range(world_size):
        grid[:, j] = devices
    return Mesh(grid), [(i, rank) for i in range(len(devices))]


class ProcessCollectives(Collectives):
    """``Collectives`` of a ``process_mesh``: sums over ``data`` within this
    process, over ``model`` across the default group (an ``all_reduce`` for
    each of this rank's cells, issued in ``data`` order, which every rank
    shares).  ``broadcast`` runs over ``data`` only, which lies within a
    process: the step broadcasts nothing over ``model``."""

    def __init__(self, mesh: Mesh, cells: list):
        super().__init__(mesh)
        self.cells = list(cells)

    def all_reduce(self, parts: dict, axis: str) -> dict:
        if axis == "data" or self.size(axis) == 1:
            return super().all_reduce(parts, axis)
        return {c: all_reduce_sum(parts[c]) for c in self.cells}

    def broadcast(self, parts: dict, axis: str) -> dict:
        if axis != "data" and self.size(axis) > 1:
            raise NotImplementedError("a process mesh broadcasts over 'data' only")
        return super().broadcast(parts, axis)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the default group, as a new tensor."""
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t)
    return t
