"""The flat kernel's 3x3 depthwise path (``op_dw3`` and ``op_dw3_stem`` in
``microflow_tpu_torch/csrc/flatpack.cu``) emulated in numpy on the CPU.

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

from microflow_tpu.ops.depthwise_conv_2d import depthwise_conv_2d_accumulate
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.kernels import flatpack as tflat
from microflow_tpu_torch.models import model_path

PD_DW = [0, 1] + list(range(3, 26, 2))  # person_detect's 14 depthwise layers
PD_PATHS = {0: tflat.DW3_STEM, **{i: tflat.DW3_S2 if i in (3, 7, 11, 23) else tflat.DW3_S1
                                  for i in PD_DW[1:]}}


def byte_perm(x, y, s: int) -> np.ndarray:
    """CUDA's ``__byte_perm(x, y, s)`` on uint32 arrays: result byte n is
    byte ``(s >> 4n) & 7`` of x (0-3) and y (4-7)."""
    src = [(np.asarray(v, np.uint64) >> np.uint64(8 * i)) & np.uint64(0xFF)
           for v in (x, y) for i in range(4)]
    out = np.zeros(np.shape(x), np.uint64)
    for n in range(4):
        out |= src[(s >> (4 * n)) & 7] << np.uint64(8 * n)
    return out


def signed_bytes(v) -> np.ndarray:
    """The four bytes of uint32 words as int64 ``[..., 4]``, low byte first,
    each as a signed int8."""
    v = np.asarray(v, np.uint64)
    b = np.stack([(v >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)], -1)
    return b.astype(np.int64) - 256 * (b >= 128)


def dp4a(x, w, acc) -> np.ndarray:
    """``__dp4a(x, w, acc)``: acc plus the dot of x's and w's signed bytes."""
    return acc + (signed_bytes(x) * signed_bytes(w)).sum(-1)


def work_items(groups: int, items: int):
    """The kernel's loop: thread t keeps channel group ``t % groups`` and
    takes items ``t // groups``, ``+ THREADS // groups``, ... below
    ``items``.  Returns the (group, item) pairs, one row a thread-item."""
    t = np.arange(tflat.THREADS)
    per = tflat.THREADS // groups
    pairs = [(t % groups, t // groups + k * per) for k in range(-(-items // per))]
    g = np.concatenate([p[0] for p in pairs])
    it = np.concatenate([p[1] for p in pairs])
    keep = it < items
    return g[keep], it[keep]


def read_words(x: np.ndarray, addr: np.ndarray, ok: np.ndarray, row_lo, row_hi, zpw):
    """32-bit words at byte ``addr`` of the input row ``x`` where ``ok``,
    else ``zpw``; every read must be aligned and inside its input row
    ``[row_lo, row_hi)``."""
    assert (addr[ok] % 4 == 0).all()
    assert (addr[ok] >= row_lo[ok]).all() and (addr[ok] + 4 <= row_hi[ok]).all()
    at = np.where(ok, addr, 0)
    b = x.view(np.uint8).astype(np.uint64)
    w = b[at] | b[at + 1] << np.uint64(8) | b[at + 2] << np.uint64(16) | b[at + 3] << np.uint64(24)
    return np.where(ok, w, np.uint64(zpw))


def plan_consts(row, buf):
    c = int(row[tflat.F_OC])
    w = buf[row[tflat.F_W]:row[tflat.F_W] + 12 * c].view(np.int32).astype(np.uint32)
    d = buf[row[tflat.F_D]:row[tflat.F_D] + 4 * c].view(np.int32).astype(np.int64)
    return w.reshape(3, c), d


def op_dw3(row, buf, x: np.ndarray) -> np.ndarray:
    """One sample through the kernel's ``op_dw3<SD>`` or ``op_dw3_stem``:
    descriptor ``row``, plan bytes ``buf``, int8 input row ``x``; returns
    the int64 accumulators ``[OH*OW, C]`` before the epilogue."""
    ih, iw, oh, ow, c, pt, pl, zp = (int(row[f]) for f in (
        tflat.F_IH, tflat.F_IW, tflat.F_OH, tflat.F_OW, tflat.F_OC, tflat.F_PT, tflat.F_PL,
        tflat.F_ZP))
    path = int(row[tflat.F_DW3])
    zpw = (zp & 0xFF) * 0x01010101
    w, d = plan_consts(row, buf)
    stem = path == tflat.DW3_STEM
    sd = 1 if path == tflat.DW3_S1 else 2
    s = tflat.STEM_STRIP if stem else tflat.DW_STRIP
    groups = c // 4
    ns = -(-ow // s)
    g, it = work_items(groups, oh * ns)
    oy = it // ns
    ox = (it - oy * ns) * s
    acc = np.repeat(d.reshape(groups, 1, 4)[g], s, axis=1)  # [items, S, 4]
    for dh in range(3):
        r = oy * sd - pt + dh
        rok = (r >= 0) & (r < ih)
        wt = [w[dh, 4 * g + j] for j in range(4)]  # channel j's taps of row dh
        if stem:
            b = 2 * ox - 4  # bytes 8s-4 .. 8s+7 of the row: three words
            words = [read_words(x, r * iw + b + 4 * m, rok & (b + 4 * m >= 0) & (b + 4 * m < iw),
                                r * iw, r * iw + iw, zpw) for m in range(3)]
            xw = [byte_perm(words[0], words[1], 0x6543), byte_perm(words[1], words[2], 0x4321),
                  byte_perm(words[1], words[2], 0x6543), words[2] >> np.uint64(8)]
            for o in range(s):
                for j in range(4):
                    acc[:, o, j] = dp4a(xw[o], wt[j], acc[:, o, j])
            continue
        nx = s + 2 if sd == 1 else 2 * s + 1
        q0 = ox * sd - pl
        xs = []
        for i in range(nx):
            q = q0 + i
            xs.append(read_words(x, (r * iw + q) * c + 4 * g, rok & (q >= 0) & (q < iw),
                                 r * iw * c, (r * iw + iw) * c, zpw))
        np_ = (nx + 1) // 2
        p01 = [byte_perm(xs[2 * i], xs[min(2 * i + 1, nx - 1)], 0x5140) for i in range(np_)]
        p23 = [byte_perm(xs[2 * i], xs[min(2 * i + 1, nx - 1)], 0x7362) for i in range(np_)]
        for i in range(np_ - 1):
            xw = [byte_perm(p01[i], p01[i + 1], 0x5410), byte_perm(p01[i], p01[i + 1], 0x7632),
                  byte_perm(p23[i], p23[i + 1], 0x5410), byte_perm(p23[i], p23[i + 1], 0x7632)]
            for j in range(4):
                if sd == 1:
                    if 2 * i < s:
                        acc[:, 2 * i, j] = dp4a(xw[j], wt[j], acc[:, 2 * i, j])
                    if 2 * i + 1 < s:
                        shifted = (wt[j].astype(np.uint64) << np.uint64(8)) & np.uint64(0xFFFFFFFF)
                        acc[:, 2 * i + 1, j] = dp4a(xw[j], shifted, acc[:, 2 * i + 1, j])
                elif i < s:
                    acc[:, i, j] = dp4a(xw[j], wt[j], acc[:, i, j])
    out = np.zeros((oh * ow, c), np.int64)
    written = np.zeros((oh * ow, c), np.int64)
    for o in range(s):
        keep = ox + o < ow
        p = (oy * ow + ox + o)[keep]
        for j in range(4):
            out[p, 4 * g[keep] + j] = acc[keep, o, j]
            np.add.at(written, (p, 4 * g[keep] + j), 1)
    assert (written == 1).all()
    assert (np.abs(out) < 2**31).all()
    return out


def _graph(name):
    if name == "dw_edge_graph":
        return chip_smoke.dw_edge_graph(np.random.default_rng(0))
    return tparse(model_path(name))


def _dw3_ops(graph):
    ops, _, _ = tflat.plan_flat(graph)
    buf, _ = tflat.pack_plan(ops)
    desc = buf[:len(ops) * tflat.NF * 4].view(np.int32).reshape(len(ops), tflat.NF)
    assert [int(r[tflat.F_DW3]) for r in desc] == [tflat.dw3_path(op) for op in ops]
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
