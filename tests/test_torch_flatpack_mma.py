"""The flat kernel's tensor-core 1x1 path (``op_pw_mma`` in
``microflow_tpu_torch/csrc/flatpack.cu``) emulated in numpy on the CPU.

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

from microflow_tpu.ops.conv_2d import conv_2d_accumulate
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.kernels import flatpack as tflat
from microflow_tpu_torch.models import model_path

LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3
BYTE = np.arange(16)
# PTX m16n8k32 .s8 fragments, lane 4g + t: a byte j of register j // 4
# (a0 row g k 4t.., a1 row g+8 k 4t.., a2 row g k 16+4t.., a3 row g+8 k 16+4t..)
A_ROW = G[:, None] + 8 * ((BYTE[None, :] // 4) % 2)
A_COL = 4 * T[:, None] + BYTE[None, :] % 4 + 16 * (BYTE[None, :] // 8)
# b byte j (b0 k 4t..4t+3, b1 k 16+4t..16+4t+3) of column g
B_ROW = 4 * T[:, None] + BYTE[None, :8] % 4 + 16 * (BYTE[None, :8] // 4)
B_COL = np.broadcast_to(G[:, None], (32, 8))
# d register i: row g (+8 for i >= 2), column 2t + i % 2
D_ROW = G[:, None] + 8 * (np.arange(4)[None, :] // 2)
D_COL = 2 * T[:, None] + np.arange(4)[None, :] % 2


def mma(d: np.ndarray, a: np.ndarray, b: np.ndarray) -> None:
    """``d [32 lanes, 4] += A x B``, A from ``a [32, 16]`` int8 bytes, B
    from ``b [32, 8]``."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    A[A_ROW, A_COL] = a
    B[B_ROW, B_COL] = b
    d += (A @ B)[D_ROW, D_COL]


def test_fragment_tables_cover_each_element_once():
    for rows, cols, shape in ((A_ROW, A_COL, (16, 32)), (B_ROW, B_COL, (32, 8)),
                              (D_ROW, D_COL, (16, 8))):
        seen = np.zeros(shape, np.int64)
        np.add.at(seen, (rows, cols), 1)
        assert (seen == 1).all()


def div16(n, d: int):
    """The kernel's ``Div16``: ``n // d`` as ``(n * M) >> 32`` with
    ``M = ceil(2**32 / d)`` split into a 32-bit ``lo`` and ``hi = d == 1``."""
    lo = np.uint64((0xFFFFFFFF // d + 1) & 0xFFFFFFFF)
    n = np.asarray(n).astype(np.uint64)
    return ((n * lo) >> np.uint64(32)).astype(np.int64) + (n.astype(np.int64) if d == 1 else 0)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 6, 7, 9, 13, 24, 48, 96, 255, 4097, 65535, 65536])
def test_div16_is_exact_below_2_16(d):
    n = np.arange(1 << 16)
    assert np.array_equal(div16(n, d), n // d)


def row_words(x: np.ndarray, off: np.ndarray, c: np.ndarray, ic: int, n: int) -> np.ndarray:
    """The kernel's ``row_words<n>`` for all lanes: ``[32, 4n]`` bytes of
    channels ``c..c+4n-1`` of the pixel row at ``off``; 0 (no read) for a
    word past ``ic`` or an absent pixel (``off < 0``)."""
    ch = c[:, None] + np.arange(4 * n)[None, :]
    ok = (off >= 0)[:, None] & (c[:, None] + 4 * (np.arange(4 * n)[None, :] // 4) < ic)
    at = off[:, None] + ch
    assert (at[ok] < x.size).all() and (at[ok] >= 0).all()
    vector = (off >= 0) & (ic % (4 * n) == 0) & (c < ic)
    assert ((off + c)[vector] % (4 * n) == 0).all()  # the vector load is aligned
    assert ((off + c)[off >= 0] % 4 == 0).all()  # every word is
    return np.where(ok, x[np.where(ok, at, 0)], 0)


def op_pw_mma(row: np.ndarray, buf: np.ndarray, x: np.ndarray) -> np.ndarray:
    """One sample through the kernel's ``op_pw_mma``: descriptor ``row``,
    plan bytes ``buf``, int8 input row ``x``; returns the int64
    accumulators ``[OH*OW, OC]`` before the epilogue."""
    iw, ic, ow, oc = (int(row[f]) for f in (tflat.F_IW, tflat.F_IC, tflat.F_OW, tflat.F_OC))
    npx, sr, sc = int(row[tflat.F_OH]) * ow, int(row[tflat.F_SR]), int(row[tflat.F_SC])
    nt = tflat.NT
    units = (ic + 31) // 32
    chunks = -(-npx // (8 * nt))
    frag = buf[row[tflat.F_W]:row[tflat.F_W] + oc * units * 32].view(np.int8)
    frag = frag.reshape(oc // 16, units, 32, 16).astype(np.int64)
    d = buf[row[tflat.F_D]:row[tflat.F_D] + 4 * oc].view(np.int32).astype(np.int64)
    out = np.zeros((npx, oc), np.int64)
    written = np.zeros((npx, oc), np.int64)
    for item in range((oc // 16) * chunks):
        m = int(div16(item, chunks))
        n0 = (item - m * chunks) * 8 * nt
        r0 = 16 * m + G
        off = []
        for j in range(nt):
            p = n0 + 8 * j + G
            row = div16(p, ow)
            off.append(np.where(p < npx, (row * sr * iw + (p - row * ow) * sc) * ic, -1))
        acc = [np.stack([d[r0], d[r0], d[r0 + 8], d[r0 + 8]], 1) for _ in range(nt)]
        u = 0
        for kb in range(0, ic, 64):
            pair = ic - kb > 32
            a = frag[m, u:u + 1 + pair]
            u += 1 + pair
            for j in range(nt):  # a tile past the pixels reads zeros
                if pair:
                    w = row_words(x, off[j], kb + 16 * T, ic, 4)
                    mma(acc[j], a[0], w[:, :8])
                    mma(acc[j], a[1], w[:, 8:])
                else:
                    mma(acc[j], a[0], row_words(x, off[j], kb + 8 * T, ic, 2))
        assert u == units
        for j in range(nt):
            assert (np.abs(acc[j]) < 2**31).all()
            for i in range(2):
                p = n0 + 8 * j + 2 * T + i
                ok = p < npx
                for rows, reg in ((r0, i), (r0 + 8, 2 + i)):
                    out[p[ok], rows[ok]] = acc[j][ok, reg]
                    written[p[ok], rows[ok]] += 1
    assert (written == 1).all()
    return out


def _mma_ops(graph):
    ops, _, _ = tflat.plan_flat(graph)
    buf, _ = tflat.pack_plan(ops)
    desc = buf[:len(ops) * tflat.NF * 4].view(np.int32).reshape(len(ops), tflat.NF)
    assert [bool(r[tflat.F_MMA]) for r in desc] == [tflat.pw_mma(op) for op in ops]
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
    assert [op.layer_idx for op in ops if tflat.pw_mma(op)] == want
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
