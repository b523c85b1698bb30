"""The flat kernel's 3x3 depthwise path (``op_dw3`` and ``op_dw3_stem`` in
``microflow_tpu_torch/csrc/segment_ops.cuh``) emulated in numpy on the CPU
(``tests/torch_emulators.py``).

The emulator follows the kernel's indexing step by step: each thread's
channel group and work items (a strip of output pixels of one row), the tap
words read from the bytes that ``pack_plan`` wrote, the shared-memory words
each item reads (``in_zp`` words outside the input), the byte permutations
that turn them into words of four consecutive columns a channel, and
``__dp4a`` as an integer dot of four signed bytes.  Its int32 accumulators
must equal exactly the JAX package's ``depthwise_conv_2d_accumulate`` (the
``ops/`` oracle) for every depthwise op that the plan puts on that path.
It also asserts that every read lies inside its input row and is aligned,
and that every output is written once.
"""

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch_parity as tp
from torch_emulators import op_dw3, signed_bytes

from microflow_tpu.ops.depthwise_conv_2d import depthwise_conv_2d_accumulate
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.kernels import flatpack as tflat
from microflow_tpu_torch.models import model_path

PD_DW = [0, 1] + list(range(3, 26, 2))  # person_detect's 14 depthwise layers
PD_PATHS = {0: tflat.DW3_STEM, **{i: tflat.DW3_S2 if i in (3, 7, 11, 23) else tflat.DW3_S1
                                  for i in PD_DW[1:]}}


def _graph(name):
    if name == "dw_edge_graph":
        return chip_smoke.dw_edge_graph(np.random.default_rng(0))
    return tparse(model_path(name))


def _dw3_ops(graph):
    ops, _, _ = tflat.plan_flat(graph)
    buf, _ = tflat.pack_plan(ops)
    desc = buf[:len(ops) * tflat.NF * 4].view(np.int32).reshape(len(ops), tflat.NF)
    assert [int(r[tflat.F_DW3]) for r in desc] == [
        tflat.dw3_path(op.geom, op.in_shape, op.out_shape) if op.kind == "dw" else 0
        for op in ops]
    return {op.layer_idx: (op, row, buf) for op, row in zip(ops, desc) if row[tflat.F_DW3]}


@pytest.mark.parametrize("name,want", [("person_detect", PD_PATHS),
                                       ("dw_edge_graph", chip_smoke.DW_EDGE_DW3),
                                       ("speech", {}), ("sine", {})])
def test_which_ops_take_the_3x3_path(name, want):
    """All 14 of person_detect's depthwise ops (the stem, 6 at stride 2, 7
    at stride 1); not speech's 10x8 stem, which stays on ``op_dw_vec``."""
    assert {i: int(row[tflat.F_DW3]) for i, (_, row, _) in _dw3_ops(_graph(name)).items()} == want


def test_edge_graph_shapes():
    """The edge graph covers what the path must handle: the IC = 1 stem with
    a partial strip, stride 2 on odd widths with SAME and VALID padding, C
    = 4, 8 and 256, widths that are not a multiple of the strip, and input
    zero points of -128 and of a positive value."""
    ops = [op for op, _, _ in _dw3_ops(_graph("dw_edge_graph")).values()]
    assert ops[0].in_shape[2] == 1 and ops[0].out_shape[1] % tflat.STEM_STRIP
    assert {op.geom.padding.name for op in ops
            if op.geom.stride_rows == 2 and op.in_shape[1] % 2} == {"SAME", "VALID"}
    assert {op.out_shape[2] for op in ops} == {4, 8, 256}
    assert any(op.out_shape[1] % tflat.DW_STRIP for op in ops[1:])
    assert -128 in {op.in_zp for op in ops} and any(op.in_zp > 0 for op in ops)


@pytest.mark.parametrize("name,layer", [("person_detect", i) for i in PD_DW]
                         + [("dw_edge_graph", i) for i in chip_smoke.DW_EDGE_DW3])
def test_emulated_kernel_equals_oracle_accumulators(name, layer):
    op, row, buf = _dw3_ops(_graph(name))[layer]
    rng = np.random.default_rng(layer)
    x = rng.integers(-128, 128, (2, *op.in_shape), dtype=np.int8)
    x.flat[:2] = (-128, 127)
    c = op.out_shape[2]
    xg = x[..., [0] * c] if op.in_shape[2] == 1 else x  # the stem broadcasts channel 0
    want = np.asarray(depthwise_conv_2d_accumulate(jnp.asarray(xg), jnp.asarray(op.weights),
                                                   tp.jax_graph(op.geom), op.in_zp,
                                                   np.zeros(c, np.int32)))
    assert want.dtype == np.int32
    for b in range(2):
        got = op_dw3(row, buf, x[b].reshape(-1))
        assert np.array_equal(got, want[b].reshape(got.shape).astype(np.int64))


def test_other_depthwise_ops_keep_the_vec_words():
    """speech's 10x8 stem stays on ``op_dw_vec``: ``F_VEC`` set, its taps
    as ``[ceil(KH*KW/4)][C]`` words of four taps each, zero-padded, and
    ``d = -in_zp * sum of all taps``."""
    ops, _, _ = tflat.plan_flat(_graph("speech"))
    buf, _ = tflat.pack_plan(ops)
    desc = buf[:len(ops) * tflat.NF * 4].view(np.int32).reshape(len(ops), tflat.NF)
    (found,) = [(op, row) for op, row in zip(ops, desc) if op.kind == "dw"]
    op, row = found
    kh, kw, c = op.weights.shape
    assert (kh, kw, c, op.in_shape[2]) == (10, 8, 8, 1)
    assert row[tflat.F_VEC] and row[tflat.F_DW3] == tflat.DW3_NONE
    n4 = -(-kh * kw // 4)
    words = buf[row[tflat.F_W]:row[tflat.F_W] + n4 * 4 * c].view(np.int32).reshape(n4, c)
    taps = words.view(np.int8).reshape(n4, c, 4).transpose(0, 2, 1).reshape(-1, c)
    assert np.array_equal(taps[:kh * kw], op.weights.reshape(-1, c))
    assert not taps[kh * kw:].any()
    d = buf[row[tflat.F_D]:row[tflat.F_D] + 4 * c].view(np.int32)
    assert np.array_equal(d, -op.in_zp * op.weights.reshape(-1, c).astype(np.int32).sum(0))


def test_tap_words_unpack_to_the_weights():
    """``dw3_words``: word (dh, c) holds taps (dh, 0..2) of channel c, low
    byte first, and a zero high byte."""
    w = np.random.default_rng(3).integers(-128, 128, (3, 3, 12), dtype=np.int8)
    words = tflat.dw3_words(w)
    assert words.shape == (3, 12) and words.dtype == np.int32
    b = signed_bytes(words.astype(np.uint32))
    assert np.array_equal(b[..., :3], w.transpose(0, 2, 1)) and not b[..., 3].any()
