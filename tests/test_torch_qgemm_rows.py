"""``qgemm``'s narrow path (``qgemm_rows`` in
``microflow_tpu_torch/csrc/qgemm.cu``, K < 64) emulated in numpy on the CPU
(``tests/torch_emulators.py::qgemm_rows``).

The emulator replays the kernel from ``[K, N]`` W and ``[M, K]`` X: the
launch (words of K a row, rows a thread, lanes a row, column chunks, the
persistent grid's blocks), the block's staged W words and constants at
their padded positions, each warp's work items in grid-stride order, each
lane's rows read by the entry point's mode (vector, words or bytes),
``__dp4a`` against the staged words and against ones, the epilogue as the
kernel orders it (y clamped first, then rounded by a truncation:
``round_byte``) and the stores by mode.  Its output must equal
``qgemm_reference`` bit for bit, and the JAX package's Pallas ``qgemm``
(interpret mode) under the FMA rule of ``torch_parity.py``.  The card runs
the kernel itself in ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_emulators as te
import torch_parity as tp
from test_torch_cuda import torch_args
from test_torch_qgemm_mma import F32, PD_SHAPES

from microflow_tpu.core import FusedActivation as JAct
from microflow_tpu.kernels import qgemm as j_qgemm
from microflow_tpu_torch.core import FusedActivation as TAct
from microflow_tpu_torch.core.activation import activation_bounds
from microflow_tpu_torch.core.numerics import np_round_away

tqgemm = importlib.import_module("microflow_tpu_torch.kernels.qgemm")

KS = (1, 3, 4, 8, 9, 16, 31, 32, 33, 63)
NS = (1, 2, 15, 16, 32, 64, 65)
ACTS = ("none", "relu", "relu6")
# the shapes the narrow path serves: person_detect's four at batch 8192,
# sine's three at batch 1,048,576
SERVED = [s for s in PD_SHAPES if s[1] < 64] + [(1 << 20, 1, 16), (1 << 20, 16, 16),
                                                (1 << 20, 16, 1)]
# resident blocks of a persistent grid: one, a few, an H100's 132 SMs at
# 3 and 4 blocks each
BLOCKS = (1, 5, 396, 528)


def _case(M, K, N, seed):
    """Random X and W, nonzero per-column w_zp, c1 scaled to K so that few
    outputs saturate."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (M, K), dtype=np.int8)
    w = rng.integers(-128, 128, (K, N), dtype=np.int8)
    wzp = rng.integers(-9, 9, N).astype(np.int32)
    d = rng.integers(-5000, 5000, N).astype(np.int32)
    bias0 = rng.normal(0, 20, N).astype(F32)
    c1 = (rng.uniform(0.5, 2.0, N) * 20 / (np.sqrt(K) * 5500)).astype(F32)
    return x, w, wzp, d, bias0, c1


@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("K", KS)
def test_emulator_matches_reference_and_pallas(K, N):
    """The step-1 grid: M with tails, X and the output at 0, 1 and 4 bytes
    past an aligned address, the three activations and four grids in turn."""
    i = KS.index(K) * len(NS) + NS.index(N)
    M, off = (37, 130, 200)[i % 3], (0, 1, 4)[i % 3]
    act = ACTS[(i // 3) % 3]
    x, w, wzp, d, bias0, c1 = _case(M, K, N, seed=i)
    kw = dict(out_scale=0.05, out_zp=4)
    lo, hi = activation_bounds(TAct(act), **kw)
    ref = tqgemm.qgemm_reference(*torch_args(x, w, wzp, d, bias0, c1), activation=TAct(act),
                                 **kw).numpy()
    got = te.qgemm_rows(x, w, wzp, d, bias0, c1, lo, hi, blocks=BLOCKS[i % 4], x_off=off,
                        out_off=off)
    assert np.array_equal(got, ref)
    jx = np.asarray(j_qgemm(*(jnp.asarray(a) for a in (x, w, wzp, d, bias0, c1)),
                            activation=JAct(act), **kw))
    q = x.astype(np.int64) @ w.astype(np.int64) - x.astype(np.int64).sum(1, keepdims=True) * wzp + d
    tp.assert_fma_rule(got, jx, *tp.epilogue_pair(c1, q.astype(F32), bias0, lo, hi))


@pytest.mark.parametrize("M,K,N,x_off,out_off", [
    (300, 8, 16, 0, 0), (300, 8, 16, 4, 4), (300, 8, 16, 1, 1),  # 8-byte rows, words, bytes
    (100, 16, 32, 8, 0), (100, 32, 64, 4, 16), (90, 32, 32, 0, 4),  # 16-byte rows need 16
    (90, 4, 16, 2, 8), (70, 12, 8, 4, 2), (70, 63, 65, 0, 0),       # K % 16 != 0: words
])
def test_emulator_read_and_store_modes(M, K, N, x_off, out_off):
    x, w, wzp, d, bias0, c1 = _case(M, K, N, seed=M + K)
    kw = dict(activation=TAct.RELU, out_scale=0.03, out_zp=-5)
    lo, hi = activation_bounds(**kw)
    ref = tqgemm.qgemm_reference(*torch_args(x, w, wzp, d, bias0, c1), **kw).numpy()
    got = te.qgemm_rows(x, w, wzp, d, bias0, c1, lo, hi, blocks=7, x_off=x_off, out_off=out_off)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("K", [4, 8, 16, 32])
def test_emulator_on_epilogue_triples(K):
    """X = 0 makes q = d[n]: ties, FMA-sensitive triples, q around 2**22 and
    2**24 (where f32(q) starts to round) through the whole path."""
    rng = np.random.default_rng(K)
    q, bias0, c1 = _triples(rng, 256)
    n = len(q)
    x = np.zeros((5, K), np.int8)
    w = rng.integers(-128, 128, (K, n), dtype=np.int8)
    wzp = np.zeros(n, np.int32)
    lo, hi = -128, 127
    ref = tqgemm.qgemm_reference(*torch_args(x, w, wzp, q.astype(np.int32), bias0, c1),
                                 activation=TAct.NONE, out_scale=1.0, out_zp=0).numpy()
    got = te.qgemm_rows(x, w, wzp, q.astype(np.int32), bias0, c1, lo, hi, blocks=3)
    assert np.array_equal(got, ref)


def _triples(rng, n_random: int):
    """(q, bias0, c1): y = b0 + c1*q exactly on k + 0.5 for k in [-140, 140]
    and an ulp either side, at +-(0.5 - 2**-25), y = +-0.5 (exactly, where
    the product allows) where f32(q) is right for q around 2**22 and 2**24,
    FMA-sensitive triples, and random ones with |q| < 2**23."""
    q, b0, c1 = [], [], []
    for k in range(-140, 141):
        qq = int(rng.integers(-64, 65))  # the tie exactly: (k + 0.5 - q) + q
        for qv, t in ((qq, np.float32(k + 0.5 - qq)),
                      (0, np.nextafter(np.float32(k + 0.5), np.float32(-1e9))),
                      (0, np.nextafter(np.float32(k + 0.5), np.float32(1e9)))):
            q.append(qv)
            c1.append(np.float32(1.0))
            b0.append(t)
    for y in (0.5 - 2**-25, -(0.5 - 2**-25)):
        q.append(0)
        c1.append(np.float32(1.0))
        b0.append(np.float32(y))
    for qq in (2**22 - 1, 2**22, 2**22 + 1, 2**24 - 1, 2**24, 2**24 + 1, 2**24 + 3, 2**31 - 1):
        for sg in (1, -1):
            t = np.float32(sg * qq) * np.float32(2.0**-20)
            for h in (np.float32(0.5), np.float32(-0.5)):
                q.append(sg * qq)
                c1.append(np.float32(2.0**-20))
                b0.append(np.float32(h - t))
    fq, fb, fc = tp.fma_sensitive(rng, 32)
    q += [int(v) for v in fq]
    b0 += list(fb)
    c1 += list(fc)
    q += rng.integers(-(2**23), 2**23, n_random).tolist()
    b0 += rng.uniform(-300, 300, n_random).astype(F32).tolist()
    c1 += rng.uniform(1e-5, 0.05, n_random).astype(F32).tolist()
    return np.array(q, np.int64), np.array(b0, F32), np.array(c1, F32)


def _round_vs_requant_clip(q, bias0, c1, lo, hi):
    """The narrow path's epilogue (clamp, then truncate) against
    ``requant_clip`` (roundf, then clamp)."""
    got = te.round_requant(q, bias0, c1, lo, hi).view(np.int8)
    want = tqgemm.requant_clip(torch.from_numpy(q.astype(np.int32)), torch.from_numpy(bias0),
                               torch.from_numpy(c1), lo, hi).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(-128, 127), (-3, 127), (-3, 37)])
def test_round_epilogue_on_edges(lo, hi):
    """Ties and their ulps, +-(0.5 - 2**-25), q around 2**22 and 2**24, y at
    both clip edges (lo - 0.5, hi + 0.5 and an ulp either side, far past),
    FMA-sensitive and random triples: bit-equal to ``requant_clip``."""
    rng = np.random.default_rng(hi - lo)
    q, bias0, c1 = _triples(rng, 4096)
    edges = []
    for e in (lo - 0.5, hi + 0.5, lo, hi, 1e9, -1e9):
        for y in (np.float32(e), np.nextafter(np.float32(e), np.float32(-2e9)),
                  np.nextafter(np.float32(e), np.float32(2e9))):
            edges.append(y)
    q = np.concatenate([q, np.zeros(len(edges), np.int64)])
    bias0 = np.concatenate([bias0, np.array(edges, F32)])
    c1 = np.concatenate([c1, np.ones(len(edges), F32)])
    _round_vs_requant_clip(q, bias0, c1, lo, hi)


def test_round_epilogue_on_random_triples():
    """2M random (q, bias0, c1) triples over the range the narrow shapes give."""
    rng = np.random.default_rng(2)
    m = 2_000_000
    q = rng.integers(-(2**21), 2**21, m)
    bias0 = rng.uniform(-150, 150, m).astype(F32)
    c1 = rng.uniform(1e-5, 0.05, m).astype(F32)
    _round_vs_requant_clip(q, bias0, c1, -128, 127)


@pytest.mark.parametrize("part", range(8))
def test_truncation_is_roundf_on_every_float(part):
    """``trunc(y + copysign(0.5 - 2**-25, y))`` equals ``roundf(y)``
    (``np_round_away``) for every f32 y with |y| <= 129, both signs: the
    bit patterns 0 .. bits(129.0), in eight parts."""
    top = int(np.float32(129.0).view(np.uint32)) + 1
    lo, hi = part * (-(-top // 8)), min(top, (part + 1) * (-(-top // 8)))
    for a in range(lo, hi, 1 << 22):
        bits = np.arange(a, min(hi, a + (1 << 22)), dtype=np.uint32)
        for sign in (np.uint32(0), np.uint32(0x80000000)):
            y = (bits | sign).view(np.float32)
            got = np.trunc((y + np.copysign(te.HALF_DOWN, y)).astype(F32))
            assert np.array_equal(got, np_round_away(y))


@pytest.mark.parametrize("M,K,N", SERVED)
@pytest.mark.parametrize("blocks", [396, 528])
def test_every_row_and_output_written_once(M, K, N, blocks):
    """At the served shapes on the persistent grid: the warps' grid-stride
    loops take every work item once, an item's lanes own each of its rows
    once, and the lanes of a row and the column chunks each column once."""
    geo = te.rows_geometry(M, K, N, blocks)
    pairs = te.rows_items(geo)
    seen = np.zeros(geo["items"], np.int64)
    np.add.at(seen, pairs[:, 1], 1)
    assert (seen == 1).all()
    assert pairs[:, 0].max() < geo["bx"] * te.THREADS // 32
    g = np.arange(32) // geo["lanes"]
    rows = (g[:, None] + geo["tile"] * np.arange(geo["rows"])[None, :]).reshape(-1)
    # each row of an item once per lane of its row
    assert np.array_equal(np.bincount(rows), np.full(geo["rows"] * geo["tile"], geo["lanes"]))
    assert geo["items"] * geo["rows"] * geo["tile"] >= M > (geo["items"] - 1) * geo["rows"] * \
        geo["tile"]
    cols = (np.arange(geo["chunks"])[:, None, None] * te.ROW_CHUNK
            + te.ROW_COLS * np.arange(geo["lanes"])[None, :, None]
            + np.arange(te.ROW_COLS)[None, None, :]).reshape(-1)
    assert np.array_equal(np.sort(cols[cols < N]), np.arange(N))
    assert geo["lanes"] * te.ROW_COLS >= min(N, te.ROW_CHUNK)


@pytest.mark.parametrize("blocks", [1, 5, 396])
@pytest.mark.parametrize("M,K,N", [(5000, 8, 16), (3001, 16, 32), (2001, 32, 64), (700, 20, 130)])
def test_emulator_on_several_items_a_warp(M, K, N, blocks):
    """More work items than warps: each warp's grid-stride loop and the
    double buffer across items, and two column chunks."""
    x, w, wzp, d, bias0, c1 = _case(M, K, N, seed=M)
    kw = dict(activation=TAct.RELU6, out_scale=0.05, out_zp=-3)
    lo, hi = activation_bounds(**kw)
    ref = tqgemm.qgemm_reference(*torch_args(x, w, wzp, d, bias0, c1), **kw).numpy()
    assert np.array_equal(te.qgemm_rows(x, w, wzp, d, bias0, c1, lo, hi, blocks=blocks), ref)


def test_kernel_constants_agree_with_the_emulator():
    """The constants read from ``qgemm.cu`` and what the kernel assumes of
    them: the staged row's padding, the lanes a row, the truncation's
    addend."""
    assert te.ROW_STRIDE == te.ROW_CHUNK + te.ROW_CHUNK // 8
    assert 32 % te.ROW_COLS == 0 and te.ROW_CHUNK % te.ROW_COLS == 0
    assert te.ROW_CHUNK // te.ROW_COLS <= 32 and te.ROW_COLS in (4, 8, 16)
    assert te.THREADS == te.qgemm_constant("kThreads") == 256
    assert min(te.ROW_ROWS, te.ROW_ROWS_WIDE) >= 1
    assert te.HALF_DOWN == np.float32(0.5) - np.float32(2**-25)
    with open(te.os.path.join(te.build.CSRC, "qgemm.cu")) as f:
        assert "copysignf(__int_as_float(0x3EFFFFFF), y)" in f.read()
    # the positions of a lane's columns are contiguous, 16-byte aligned
    for cb in range(0, te.ROW_CHUNK, te.ROW_COLS):
        pos = te.row_position(np.arange(cb, cb + te.ROW_COLS))
        assert np.array_equal(pos, pos[0] + np.arange(te.ROW_COLS)) and pos[0] % 4 == 0
    # lanes of one warp reading the same group of four columns hit distinct banks
    for cols in (16, 8):
        lanes = te.ROW_CHUNK // cols
        banks = [(te.row_position(s * cols) // 4) % 8 for s in range(lanes)]
        assert len(set(banks)) == lanes
