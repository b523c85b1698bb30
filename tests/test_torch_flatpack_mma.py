"""The flat kernel's tensor-core 1x1 path (``op_pw_mma`` in
``microflow_tpu_torch/csrc/segment_ops.cuh``) emulated in numpy on the CPU
(``tests/torch_emulators.py``).

The emulator follows the kernel's indexing step by step: a warp's work
items (m-tile, chunk of ``NT`` pixel tiles), the A units read from the
bytes that ``pack_plan`` wrote, the B words each lane reads from the
``[pixel][IC]`` input row (16 bytes a lane for a pair of k-steps, 8 for a
last step of at most 32 channels, 0 past the channels or the pixels), and
``mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`` by PTX's fragment
tables for ``.s8``.  Its int32 accumulators must equal exactly the JAX
package's ``conv_2d_accumulate`` (the ``ops/`` oracle) for every 1x1 conv
that the plan puts on that path.  It also asserts where the kernel reads
(aligned vector loads, every word inside the row) and that every output is
written once.
"""

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch_parity as tp
from torch_emulators import A_COL, A_ROW, B_COL, B_ROW, D_COL, D_ROW, div16, op_pw_mma

from microflow_tpu.ops.conv_2d import conv_2d_accumulate
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.kernels import flatpack as tflat
from microflow_tpu_torch.models import model_path


def test_fragment_tables_cover_each_element_once():
    for rows, cols, shape in ((A_ROW, A_COL, (16, 32)), (B_ROW, B_COL, (32, 8)),
                              (D_ROW, D_COL, (16, 8))):
        seen = np.zeros(shape, np.int64)
        np.add.at(seen, (rows, cols), 1)
        assert (seen == 1).all()


@pytest.mark.parametrize("d", [1, 2, 3, 5, 6, 7, 9, 13, 24, 48, 96, 255, 4097, 65535, 65536])
def test_div16_is_exact_below_2_16(d):
    n = np.arange(1 << 16)
    assert np.array_equal(div16(n, d), n // d)


def _mma_ops(graph):
    ops, _, _ = tflat.plan_flat(graph)
    buf, _ = tflat.pack_plan(ops)
    desc = buf[:len(ops) * tflat.NF * 4].view(np.int32).reshape(len(ops), tflat.NF)
    assert [bool(r[tflat.F_MMA]) for r in desc] == [
        op.kind == "pw" and tflat.pw_mma(op.in_shape, op.out_shape) for op in ops]
    return [(op, row, buf) for op, row in zip(ops, desc) if row[tflat.F_MMA]]


def _graph(name):
    if name == "pw_edge_graph":
        return chip_smoke.pw_edge_graph(np.random.default_rng(0))
    return tparse(model_path(name))


@pytest.mark.parametrize("name,want", [("person_detect", list(range(2, 27, 2))),
                                       ("pw_edge_graph", chip_smoke.PW_EDGE_MMA),
                                       ("speech", []), ("sine", [])])
def test_which_ops_take_the_tensor_cores(name, want):
    """Every 1x1 conv with a multiple of 16 output channels: person_detect's
    layers 2-26, not the head (layer 28, 2 channels)."""
    ops, _, _ = tflat.plan_flat(_graph(name))
    assert [op.layer_idx for op in ops
            if op.kind == "pw" and tflat.pw_mma(op.in_shape, op.out_shape)] == want
    assert [op.layer_idx for op, _, _ in _mma_ops(_graph(name))] == want


def _case(name, layer):
    (found,) = [c for c in _mma_ops(_graph(name)) if c[0].layer_idx == layer]
    return found


@pytest.mark.parametrize("name,layer", [("person_detect", i) for i in range(2, 27, 2)]
                         + [("pw_edge_graph", i) for i in chip_smoke.PW_EDGE_MMA])
def test_emulated_kernel_equals_oracle_accumulators(name, layer):
    op, row, buf = _case(name, layer)
    rng = np.random.default_rng(layer)
    x = rng.integers(-128, 128, (2, *op.in_shape), dtype=np.int8)
    x.flat[:2] = (-128, 127)
    want = np.asarray(conv_2d_accumulate(jnp.asarray(x), jnp.asarray(op.weights),
                                         tp.jax_graph(op.geom), op.in_zp,
                                         np.zeros(op.out_shape[2], np.int32)))
    assert want.dtype == np.int32
    for b in range(2):
        got = op_pw_mma(row, buf, x[b].reshape(-1))
        assert np.array_equal(got, want[b].reshape(got.shape).astype(np.int64))
