"""The one rule for how a train step folds a conv or depthwise layer's weight
gradients (``train/trainer.py::fold_path``), the collectives along an axis of
one index, which the one-cell step of ``TrainableModel`` runs through, and
the loop that runs every cell's program in step (``Cells.run``).  The
rule is read from what a step can observe, so the cases fake a batch on a
device this machine has not, as ``tests/test_torch_qwgrad.py`` does.  This
file imports neither JAX nor ``microflow_tpu``."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from microflow_tpu_torch.models import person_detect_trainable
from microflow_tpu_torch.parallel import Collectives, make_mesh
from microflow_tpu_torch.parallel.distributed import ProcessCollectives, process_mesh
from microflow_tpu_torch.train import optimizer
from microflow_tpu_torch.train import trainer as ttrainer

CPU = torch.device("cpu")
BATCH = 1024
EDGE = 2**31 - 1 - optimizer.fold_margin(BATCH)  # the last bound of a plain sum at BATCH


@pytest.fixture(scope="module")
def layers():
    """person_detect's 1x1 conv (layer 24), a 3x3 conv made from it, and a
    depthwise layer (23)."""
    graph = person_detect_trainable(10, device="cpu").graph
    one = graph.layers[24]
    three = dataclasses.replace(one, filters=np.zeros((256, 3, 3, 128), np.int8),
                                geom=dataclasses.replace(one.geom, k_rows=3, k_cols=3))
    return {"1x1": one, "3x3": three, "dw": graph.layers[23]}


def batch(rows: int, device="cuda", dtype=torch.int8):
    """What the rule reads of a cell's batch."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                 shape=(rows, 3, 3, 128))


# (layer, device, dtype, mode, bound, data indices) -> path; a cell's batch
# is the global batch over the data indices
CASES = {
    "kernel": ("1x1", "cuda", torch.int8, "quantized", 0, 1, ttrainer.KERNEL),
    "kernel_at_the_edge": ("1x1", "cuda", torch.int8, "quantized", EDGE, 1, ttrainer.KERNEL),
    "over_the_margin": ("1x1", "cuda", torch.int8, "quantized", EDGE + 1, 1, ttrainer.SERIAL),
    "no_host_bound": ("1x1", "cuda", torch.int8, "quantized", None, 1, ttrainer.SERIAL),
    "cpu": ("1x1", "cpu", torch.int8, "quantized", 0, 1, ttrainer.SERIAL),
    "not_int8": ("1x1", "cuda", torch.uint8, "quantized", 0, 1, ttrainer.SERIAL),
    "3x3": ("3x3", "cuda", torch.int8, "quantized", 0, 1, ttrainer.SERIAL),
    "depthwise": ("dw", "cuda", torch.int8, "quantized", 0, 1, ttrainer.SERIAL),
    "float_mode": ("1x1", "cuda", torch.int8, "float", 0, 1, ttrainer.SERIAL),
    "sum_over_data": ("1x1", "cuda", torch.int8, "quantized", 0, 4, ttrainer.SUM),
    "sum_on_the_cpu": ("3x3", "cpu", torch.uint8, "quantized", 0, 4, ttrainer.SUM),
    "sum_of_depthwise": ("dw", "cpu", torch.int8, "quantized", EDGE, 4, ttrainer.SUM),
    # the margin is the global batch's, not the cell's quarter of it
    "over_the_global_margin": ("1x1", "cuda", torch.int8, "quantized", EDGE + 1, 4,
                               ttrainer.SERIAL),
    "no_host_bound_over_data": ("dw", "cpu", torch.int8, "quantized", None, 4,
                                ttrainer.SERIAL),
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_rule_picks_each_path_where_it_is_defined(layers, case):
    name, device, dtype, mode, bound, n_data, want = CASES[case]
    x = batch(BATCH // n_data, device, dtype)
    assert ttrainer.fold_path(layers[name], x, mode, bound, BATCH, n_data) == want


def test_the_rule_reads_the_kernels_rule_when_called(layers, monkeypatch):
    """The kernel's own rule decides at one data index, read at each call."""
    from microflow_tpu_torch.kernels import qwgrad

    monkeypatch.setattr(qwgrad, "takes_kernel", lambda *a: False)
    x = batch(BATCH)
    assert ttrainer.fold_path(layers["1x1"], x, "quantized", 0, BATCH, 1) == ttrainer.SERIAL
    assert ttrainer.fold_path(layers["1x1"], x, "quantized", 0, BATCH, 4) == ttrainer.SUM


def one_index_axes():
    """(collectives, axis of one index on its mesh) with this process
    holding one, or more, of the other axis's indices."""
    yield Collectives(make_mesh(1, 3, devices=[CPU] * 3)), "data"
    yield Collectives(make_mesh(3, 1, devices=[CPU] * 3)), "model"
    yield Collectives(make_mesh(1, 1, devices=[CPU])), "data"
    # a world of one rank: its model axis needs no process group
    mesh, cells = process_mesh([CPU] * 2, 1, 0)
    yield ProcessCollectives(mesh, cells), "model"


@pytest.mark.parametrize("index", range(4))
@pytest.mark.parametrize("op", ["all_reduce", "broadcast", "gather"])
def test_along_an_axis_of_one_index_a_collective_returns_its_tensors(index, op):
    coll, axis = list(one_index_axes())[index]
    parts = {c: torch.full((2, 3), 10 * c[0] + c[1], dtype=torch.int32) for c in coll.cells}
    args = (0, [2]) if op == "gather" else ()
    out = getattr(coll, op)(parts, axis, *args)
    assert out.keys() == parts.keys()
    assert all(out[c] is parts[c] for c in coll.cells)


def test_run_meets_every_cells_program_in_step_and_refuses_a_stray_one():
    """Each cell's program gets its part of every meeting; programs that
    end at different points raise."""
    coll = Collectives(make_mesh(2, 2, devices=[CPU] * 4))
    cells = ttrainer.Cells(coll, {CPU: ({}, {})})

    def program(c):
        total = yield "all_reduce", torch.tensor([10 * c[0] + c[1]]), "data"
        whole = yield "gather", torch.tensor([[c[1]]]), "model", 1, [1, 1]
        return int(total), whole.tolist()

    assert cells.run(program) == {c: (10 + 2 * c[1], [[0, 1]]) for c in coll.cells}

    def stray(c):
        if c[0] == 0:
            yield "all_reduce", torch.tensor([1]), "data"
        return c

    with pytest.raises(RuntimeError, match="meet where"):
        cells.run(stray)
