"""The port's depthwise kernel (``microflow_tpu_torch/kernels/qdwconv.py``,
``csrc/qdwconv.cu``) on the CPU.

Its plain version, which takes the unpadded input, is held against the JAX
package's Pallas kernel (interpret mode) fed the numpy-padded input, under
the FMA rule of ``torch_parity.py``: at all 14 of person_detect's
depthwise layers (their weights and constants) at batch 2, at speech's
10x8/s2 stem cut to size and at odd sizes.

The kernel's 3x3 tile paths (``qdwconv_tile``: a block stages a band of
input rows with its halo in shared memory, a thread computes strips of
output pixels for one group of 4 channels) are emulated in numpy step by
step, with the launch ``plan`` the wrapper uses: the staging units each
thread copies (in_zp outside the input), the shared-memory words each work
item reads, the byte permutations and ``__dp4a``.  The emulator asserts
that every global read is aligned and inside its input row, that every
shared byte is written once and every shared read is aligned and inside
its staged row, and that every output is written once; its int32
accumulators must equal the JAX package's ``depthwise_conv_2d_accumulate``
exactly.  The kernel itself runs on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity as tp

from microflow_tpu.core import FusedActivation as JAct
from microflow_tpu.kernels import qdwconv as j_qdwconv
from microflow_tpu.ops.depthwise_conv_2d import depthwise_conv_2d_accumulate
from microflow_tpu_torch.compiler.ir import DepthwiseConv2DLayer
from microflow_tpu_torch.core import FusedActivation as TAct
from microflow_tpu_torch.core.numerics import broadcast_per_channel
from microflow_tpu_torch.core.tensor import ViewGeometry, ViewPadding
from microflow_tpu_torch.frontend import parse
from microflow_tpu_torch.kernels import LAUNCHES, qdwconv, qdwconv_reference
from microflow_tpu_torch.models import model_path
from test_torch_cuda import np_zp_padded, torch_args
from torch_emulators import byte_perm, dp4a

kq = importlib.import_module("microflow_tpu_torch.kernels.qdwconv")  # the module, not the function
F32 = np.float32
PD_DW = [0, 1] + list(range(3, 26, 2))  # person_detect's 14 depthwise layers


def _pd_layers():
    g = parse(model_path("person_detect"))
    return {layer.index: layer for layer in g.layers if isinstance(layer, DepthwiseConv2DLayer)}


PD_LAYERS = _pd_layers()


def geometry(H, W, k, s, pad, kw=None):
    """The kernel's keywords for a k x kw window at stride s, SAME or VALID
    as the reference pads (SAME: top/left ``(k - 1) // 2``)."""
    kw = k if kw is None else kw
    if pad == "SAME":
        g = ViewGeometry(H, W, k, kw, -(-H // s), -(-W // s), s, s, ViewPadding.SAME)
    else:
        g = ViewGeometry(H, W, k, kw, (H - k) // s + 1, (W - kw) // s + 1, s, s, ViewPadding.VALID)
    top, _, left, _ = g.pad_amounts()
    return dict(pad_top=top, pad_left=left, kh=k, kw=kw, sr=s, sc=s, oh=g.out_rows,
                ow=g.out_cols), g


def layer_case(layer, B, rng):
    """person_detect depthwise layer ``layer``'s weights, constants and
    geometry, on a random int8 input that holds -128 and 127."""
    geom = layer.geom
    cin = 1 if layer.index == 0 else layer.weights.shape[2]
    x = rng.integers(-128, 128, (B, geom.in_rows, geom.in_cols, cin), dtype=np.int8)
    x.flat[:2] = (-128, 127)
    c = layer.weights.shape[2]
    wzp = broadcast_per_channel(layer.w_q.zero_point, c, np.int32)
    wc = layer.weights.astype(np.int32) - wzp[None, None, :]
    in_zp = layer.in_q.zp0
    d = (-in_zp * wc.sum(axis=(0, 1))).astype(np.int32)
    bias0 = (F32(layer.out_q.zp0) + layer.c0.astype(F32)).astype(F32)
    c1 = broadcast_per_channel(layer.c1, c, np.float32)
    top, _, left, _ = geom.pad_amounts()
    kw = dict(in_zp=in_zp, pad_top=top, pad_left=left, kh=geom.k_rows, kw=geom.k_cols,
              sr=geom.stride_rows, sc=geom.stride_cols, oh=geom.out_rows, ow=geom.out_cols,
              activation=layer.activation, out_scale=float(layer.out_q.scale0),
              out_zp=layer.out_q.zp0)
    return x, wc, d, bias0, c1, kw, geom


def random_case(rng, B, H, W, cin, C, geo, in_zp, w_zp=0):
    x = rng.integers(-128, 128, (B, H, W, cin), dtype=np.int8)
    x.flat[:2] = (-128, 127)
    w = rng.integers(-128, 128, (geo["kh"], geo["kw"], C), dtype=np.int8)
    w[0, 0, 0::2], w[-1, -1, 1::2] = -128, 127
    wc = w.astype(np.int32) - np.asarray(np.broadcast_to(w_zp, (C,)), np.int32)[None, None, :]
    d = (-in_zp * wc.sum(axis=(0, 1))).astype(np.int32)
    bias0 = rng.normal(0, 20, C).astype(F32)
    c1 = rng.uniform(1e-3, 5e-3, C).astype(F32)
    return x, wc, d, bias0, c1, dict(in_zp=in_zp, **geo)


# --- the plain version against the JAX kernel --------------------------------


def check_against_pallas(x, wc, d, bias0, c1, kw):
    """``qdwconv_reference`` on the unpadded input against the JAX kernel
    on the numpy-padded one, under the FMA rule."""
    C = wc.shape[2]
    geo = {k: kw[k] for k in ("in_zp", "pad_top", "pad_left", "kh", "kw", "sr", "sc", "oh", "ow")}
    xp = np_zp_padded(x, C, geo)
    act = JAct(kw["activation"].value)
    jkw = dict(kh=kw["kh"], kw=kw["kw"], sr=kw["sr"], sc=kw["sc"], oh=kw["oh"], ow=kw["ow"],
               out_scale=kw["out_scale"], out_zp=kw["out_zp"])
    ref = np.asarray(j_qdwconv(*(jnp.asarray(a) for a in (xp, wc, d, bias0, c1)),
                               activation=act, **jkw))
    got = qdwconv_reference(*torch_args(x, wc, d, bias0, c1), **kw).numpy()
    q = np.zeros(ref.shape, np.int64)
    for m in range(kw["kh"]):
        for n in range(kw["kw"]):
            q += xp[:, m::kw["sr"], n::kw["sc"], :][:, :kw["oh"], :kw["ow"], :].astype(np.int64) \
                * wc[m, n]
    q += d
    lo, hi = tp.bounds(act, kw["out_scale"], kw["out_zp"], np.int8)
    tp.assert_fma_rule(got, ref, *tp.epilogue_pair(c1, q.astype(F32), bias0, lo, hi))


@pytest.mark.parametrize("layer", PD_DW)
def test_reference_matches_pallas_on_person_detect(layer):
    """Layer 0 is the stem: one input channel to 8."""
    x, wc, d, bias0, c1, kw, _ = layer_case(PD_LAYERS[layer], 2, np.random.default_rng(layer))
    check_against_pallas(x, wc, d, bias0, c1, kw)


@pytest.mark.parametrize("B,H,W,cin,C,k,kw_,s,pad,in_zp", [
    (2, 21, 18, 1, 8, 10, 8, 2, "SAME", -128),  # speech's 10x8/s2 stem, cut to size
    (3, 11, 13, 12, 12, 3, 3, 2, "SAME", 45),   # odd sizes at stride 2
    (2, 9, 7, 5, 5, 3, 3, 1, "VALID", 3),       # C % 4 != 0, VALID
    (1, 13, 15, 1, 8, 3, 3, 2, "SAME", -7),     # the stem at an odd width
    (2, 2, 1, 4, 4, 3, 3, 1, "SAME", 99),       # smaller than a strip and a band
])
def test_reference_matches_pallas_at_odd_shapes(B, H, W, cin, C, k, kw_, s, pad, in_zp):
    rng = np.random.default_rng(H * W + C)
    geo, _ = geometry(H, W, k, s, pad, kw_)
    x, wc, d, bias0, c1, kw = random_case(rng, B, H, W, cin, C, geo, in_zp, w_zp=rng.integers(
        -4, 5, C))
    kw.update(activation=TAct.RELU6, out_scale=0.05, out_zp=-9)
    check_against_pallas(x, wc, d, bias0, c1, kw)


def test_cpu_wrapper_is_the_plain_version():
    rng = np.random.default_rng(4)
    geo, _ = geometry(9, 10, 3, 2, "SAME")
    x, wc, d, bias0, c1, kw = random_case(rng, 3, 9, 10, 1, 8, geo, -3)
    kw.update(activation=TAct.RELU, out_scale=0.05, out_zp=2)
    args = torch_args(x, wc, d, bias0, c1)
    before = LAUNCHES.copy()
    assert torch.equal(qdwconv(*args, **kw, int8_taps=True), qdwconv_reference(*args, **kw))
    assert LAUNCHES == before


# --- the launch plan ---------------------------------------------------------


def _plan(B, H, W, cin, C, geo, int8_taps=True, x_align=16):
    return kq.plan(B, H, W, cin, C, **{k: v for k, v in geo.items() if k != "in_zp"},
                   int8_taps=int8_taps, x_align=x_align)


def _layer_plan(layer, B=8192):
    _, wc, _, _, _, kw, geom = layer_case(layer, 1, np.random.default_rng(0))
    geo = {k: kw[k] for k in ("pad_top", "pad_left", "kh", "kw", "sr", "sc", "oh", "ow")}
    cin = 1 if layer.index == 0 else wc.shape[2]
    return _plan(B, geom.in_rows, geom.in_cols, cin, wc.shape[2], geo,
                 int8_taps=not np.any(layer.w_q.zero_point))


def test_person_detect_takes_the_tile_paths():
    """All 14 layers: the stem, 6 at stride 2 and 7 at stride 1, each row
    staged in 16-byte units; every tile fits the shared-memory budget and
    gives each thread 1.5 to 4.5 work items."""
    paths = {}
    for i, layer in PD_LAYERS.items():
        p = _layer_plan(layer)
        paths[i] = p.path
        assert p.vec == 16
        assert p.samples * p.staged_rows * p.pitch <= kq.MAX_TILE
        ns = -(-layer.geom.out_cols // p.strip)
        items = p.samples * p.rows * ns * (layer.weights.shape[2] // 4)
        assert 1.5 <= items / p.threads <= 4.5, (i, p)
    assert paths == {0: kq.PATH_STEM, **{i: kq.PATH_S2 if i in (3, 7, 11, 23) else kq.PATH_S1
                                         for i in PD_DW[1:]}}


@pytest.mark.parametrize("what,args,int8_taps,want", [
    ("speech's 10x8/s2 stem", (2, 49, 40, 1, 8, geometry(49, 40, 10, 2, "SAME", 8)[0]), True,
     (kq.PATH_GENERAL, 4)),
    ("C % 4 != 0", (2, 9, 9, 6, 6, geometry(9, 9, 3, 1, "SAME")[0]), True, (kq.PATH_GENERAL, 1)),
    ("weights that need i32", (2, 9, 9, 8, 8, geometry(9, 9, 3, 1, "SAME")[0]), False,
     (kq.PATH_GENERAL, 4)),
    ("a 5x5 window", (2, 9, 9, 8, 8, geometry(9, 9, 5, 1, "SAME")[0]), True, (kq.PATH_GENERAL, 4)),
    ("the stem at stride 1", (2, 9, 9, 1, 8, geometry(9, 9, 3, 1, "SAME")[0]), True,
     (kq.PATH_GENERAL, 4)),
    ("the stem, VALID", (2, 9, 9, 1, 8, geometry(9, 9, 3, 2, "VALID")[0]), True,
     (kq.PATH_GENERAL, 4)),
    ("a row of 20 bytes", (2, 9, 5, 4, 4, geometry(9, 5, 3, 2, "SAME")[0]), True, (kq.PATH_S2, 4)),
    ("the stem at an odd width", (2, 9, 15, 1, 8, geometry(9, 15, 3, 2, "SAME")[0]), True,
     (kq.PATH_STEM, 1)),
    ("an input at an odd address", (2, 9, 8, 8, 8, geometry(9, 8, 3, 1, "SAME")[0]), True,
     (kq.PATH_S1, 1)),
])
def test_plan_paths(what, args, int8_taps, want):
    p = _plan(*args, int8_taps=int8_taps, x_align=1 if "odd address" in what else 16)
    assert (p.path, p.vec) == want, what


# --- the tile paths emulated -------------------------------------------------


def read_word(tile: np.ndarray, addr: np.ndarray) -> np.ndarray:
    t = tile.astype(np.uint64)
    return t[addr] | t[addr + 1] << np.uint64(8) | t[addr + 2] << np.uint64(16) \
        | t[addr + 3] << np.uint64(24)


def stage(x: np.ndarray, p, H, W, cin, b0, r0, zp) -> np.ndarray:
    """The tile one block stages (``stage<VEC>``): every global read
    aligned and inside its input row, every shared byte written once."""
    B = x.shape[0]
    u = 16 if p.vec == 16 else 4
    units = p.pitch // u
    row_bytes = W * cin
    i = np.arange(p.samples * p.staged_rows * units)
    sr_ = i // units
    k = sr_ // p.staged_rows
    r, b = r0 + sr_ - k * p.staged_rows, b0 + k
    o = (i - sr_ * units) * u - p.margin
    row_in = (b < B) & (r >= 0) & (r < H)
    xb = x.reshape(-1).view(np.uint8)
    tile = np.zeros(len(i) * u, np.uint8)
    count = np.zeros(len(i) * u, np.int64)
    base = (b * H + r) * row_bytes
    if p.vec > 1:  # a unit is all input or all halo, and read whole
        unit_in = row_in & (o >= 0) & (o < row_bytes)
        assert (o[unit_in] + u <= row_bytes).all()
        assert ((base + o)[unit_in] % p.vec == 0).all()
    for e in range(u):
        inside = row_in & (o + e >= 0) & (o + e < row_bytes)
        if p.vec > 1:
            assert (inside == unit_in).all()
        addr = np.where(inside, base + o + e, 0)
        assert (addr[inside] < xb.size).all()
        tile[i * u + e] = np.where(inside, xb[addr], np.uint8(zp & 0xFF))
        np.add.at(count, i * u + e, 1)
    assert (count == 1).all()
    return tile


def tap_words(wc: np.ndarray) -> np.ndarray:
    """``Consts``: word [dh, c] = taps (dh, 0..2) of channel c, low byte
    first, high byte 0 (the centred weights fit int8)."""
    assert wc.min() >= -128 and wc.max() <= 127
    b = wc.astype(np.int64) & 0xFF
    return (b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16).astype(np.uint64)


def emulate(x, wc, d, kw, p) -> np.ndarray:
    """One call through ``qdwconv_tile`` with plan ``p``: the int64
    accumulators [B, OH, OW, C] before the epilogue."""
    B, H, W, cin = x.shape
    C = wc.shape[2]
    oh, ow, pt, pl, zp = kw["oh"], kw["ow"], kw["pad_top"], kw["pad_left"], kw["in_zp"]
    stem = p.path == kq.PATH_STEM
    sd = 1 if p.path == kq.PATH_S1 else 2
    S = p.strip
    groups = C // 4
    assert p.threads == (kq.THREADS // groups) * groups
    ns = -(-ow // S)
    per = p.rows * ns
    bands = -(-oh // p.rows)
    assert p.blocks == -(-B // p.samples) * bands
    taps = tap_words(wc)
    out = np.zeros((B, oh, ow, C), np.int64)
    written = np.zeros((B, oh, ow, C), np.int64)
    t = np.arange(p.threads)
    slots = p.threads // groups
    reps = -(-p.samples * per // slots)
    g = np.tile(t % groups, reps)
    it = np.concatenate([t // groups + m * slots for m in range(reps)])
    keep = it < p.samples * per
    g, it = g[keep], it[keep]
    for blk in range(p.blocks):
        bg, band = divmod(blk, bands)
        b0, oy0 = bg * p.samples, band * p.rows
        tile = stage(x, p, H, W, cin, b0, oy0 * sd - pt, zp)
        k = it // per
        rem = it - k * per
        oyl = rem // ns
        ox = (rem - oyl * ns) * S
        live = (b0 + k < B) & (oy0 + oyl < oh)
        kk, ol, oxx, gg = k[live], oyl[live], ox[live], g[live]
        acc = np.repeat(d.astype(np.int64).reshape(groups, 1, 4)[gg], S, axis=1)  # [items, S, 4]

        def word(addr, staged_row):
            assert (addr % 4 == 0).all()
            assert (addr >= staged_row * p.pitch).all()
            assert (addr + 4 <= (staged_row + 1) * p.pitch).all()
            return read_word(tile, addr)

        for dh in range(3):
            srow = kk * p.staged_rows + ol * sd + dh
            wt = [taps[dh, 4 * gg + j] for j in range(4)]
            if stem:
                base = srow * p.pitch + p.margin - 4 + 2 * oxx
                w = [word(base + 4 * m, srow) for m in range(3)]
                xw = [byte_perm(w[0], w[1], 0x6543), byte_perm(w[1], w[2], 0x4321),
                      byte_perm(w[1], w[2], 0x6543), w[2] >> np.uint64(8)]
                for o in range(S):
                    for j in range(4):
                        acc[:, o, j] = dp4a(xw[o], wt[j], acc[:, o, j])
                continue
            nx = S + 2 if sd == 1 else 2 * S + 1
            base = srow * p.pitch + p.margin - pl * C + 4 * gg + oxx * sd * C
            xs = [word(base + i * C, srow) for i in range(nx)]
            np_ = (nx + 1) // 2
            p01 = [byte_perm(xs[2 * i], xs[min(2 * i + 1, nx - 1)], 0x5140) for i in range(np_)]
            p23 = [byte_perm(xs[2 * i], xs[min(2 * i + 1, nx - 1)], 0x7362) for i in range(np_)]
            for i in range(np_ - 1):
                xw = [byte_perm(p01[i], p01[i + 1], 0x5410), byte_perm(p01[i], p01[i + 1], 0x7632),
                      byte_perm(p23[i], p23[i + 1], 0x5410), byte_perm(p23[i], p23[i + 1], 0x7632)]
                for j in range(4):
                    if sd == 1:
                        if 2 * i < S:
                            acc[:, 2 * i, j] = dp4a(xw[j], wt[j], acc[:, 2 * i, j])
                        if 2 * i + 1 < S:
                            sh = (wt[j] << np.uint64(8)) & np.uint64(0xFFFFFFFF)
                            acc[:, 2 * i + 1, j] = dp4a(xw[j], sh, acc[:, 2 * i + 1, j])
                    elif i < S:
                        acc[:, i, j] = dp4a(xw[j], wt[j], acc[:, i, j])
        for o in range(S):
            on = oxx + o < ow
            b, oy, q = (b0 + kk)[on], (oy0 + ol)[on], (oxx + o)[on]
            for j in range(4):
                out[b, oy, q, 4 * gg[on] + j] = acc[on, o, j]
                np.add.at(written, (b, oy, q, 4 * gg[on] + j), 1)
    assert (written == 1).all()
    return out


def oracle(x, wc, kw, C):
    """The JAX package's ``depthwise_conv_2d_accumulate`` (the stem's one
    channel repeated to C; the centred weights fit int8, with w_zp = 0)."""
    xs = x if x.shape[3] == C else np.repeat(x, C, axis=3)
    geom = ViewGeometry(x.shape[1], x.shape[2], kw["kh"], kw["kw"], kw["oh"], kw["ow"], kw["sr"],
                        kw["sc"], ViewPadding.SAME if kw["pad_top"] or kw["pad_left"]
                        else ViewPadding.VALID)
    assert (geom.pad_amounts()[0], geom.pad_amounts()[2]) == (kw["pad_top"], kw["pad_left"])
    want = np.asarray(depthwise_conv_2d_accumulate(
        jnp.asarray(xs), jnp.asarray(wc.astype(np.int8)), tp.jax_graph(geom), kw["in_zp"],
        np.zeros(C, np.int32)))
    assert want.dtype == np.int32
    return want.astype(np.int64)


@pytest.mark.parametrize("layer", PD_DW)
def test_emulated_tile_equals_oracle_on_person_detect(layer):
    x, wc, d, _, _, kw, _ = layer_case(PD_LAYERS[layer], 2, np.random.default_rng(layer + 50))
    p = _layer_plan(PD_LAYERS[layer], B=2)
    assert p.path != kq.PATH_GENERAL
    assert np.array_equal(emulate(x, wc, d, kw, p), oracle(x, wc, kw, wc.shape[2]))


# (B, H, W, cin, C, stride, padding, in_zp): the edges of the tile paths
EDGE = [
    (3, 2, 2, 8, 8, 1, "SAME", 99),       # smaller than a strip and a band
    (1, 1, 1, 4, 4, 1, "SAME", -128),     # one pixel, one channel group
    (2, 1, 5, 16, 16, 2, "SAME", 7),      # one row at stride 2
    (2, 11, 13, 12, 12, 2, "SAME", 45),   # odd sizes at stride 2; G = 3 (255 threads)
    (3, 10, 9, 8, 8, 2, "VALID", -1),     # VALID, odd width at stride 2
    (2, 7, 8, 20, 20, 1, "VALID", 60),    # VALID at stride 1; rows of 160 bytes
    (2, 13, 15, 1, 8, 2, "SAME", -7),     # the stem at an odd width: byte staging
    (5, 9, 12, 1, 12, 2, "SAME", 3),      # the stem to 12 channels, 5 samples
    (2, 9, 5, 4, 4, 2, "SAME", -60),      # rows of 20 bytes: 4-byte staging
    (1, 48, 48, 8, 8, 1, "SAME", -128),   # a band split, batch 1
    (7, 3, 3, 256, 256, 1, "SAME", 11),   # several samples a block, B not a multiple
    (3, 4, 4, 1024, 1024, 2, "SAME", 0),  # G = 256: one strip a time
]


@pytest.mark.parametrize("B,H,W,cin,C,s,pad,in_zp", EDGE)
def test_emulated_tile_equals_oracle_at_the_edges(B, H, W, cin, C, s, pad, in_zp):
    rng = np.random.default_rng(B * H * W + C)
    geo, _ = geometry(H, W, 3, s, pad)
    x, wc, d, _, _, kw = random_case(rng, B, H, W, cin, C, geo, in_zp)
    p = _plan(B, H, W, cin, C, geo)
    assert p.path == (kq.PATH_STEM if cin == 1 else kq.PATH_S1 if s == 1 else kq.PATH_S2)
    assert np.array_equal(emulate(x, wc, d, kw, p), oracle(x, wc, kw, C))


def test_edge_cases_cover_the_staging_widths_and_block_shapes():
    plans = [_plan(B, H, W, cin, C, geometry(H, W, 3, s, pad)[0])
             for B, H, W, cin, C, s, pad, _ in EDGE]
    assert {p.vec for p in plans} == {16, 4, 1}
    assert any(p.samples > 1 for p in plans) and any(p.rows < p_oh for p, p_oh in zip(
        plans, [geometry(H, W, 3, s, pad)[0]["oh"] for _, H, W, _, _, s, pad, _ in EDGE]))
