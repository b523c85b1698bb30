"""numpy emulators of the shared op paths of the whole-network kernels
(``microflow_tpu_torch/csrc/segment_ops.cuh``, which ``flatpack.cu`` and
``megakernel.cu`` both include): ``op_pw_mma``, ``op_dw3`` /
``op_dw3_stem`` and ``op_dw_vec``.

Each emulator follows the kernel's indexing step by step on one sample:
the work items, the constants read from the plan bytes that
``kernels/flatpack.py::pack_plan`` or ``kernels/megakernel.py::pack_segment``
wrote (both write the same descriptor layout), the shared-memory words each
thread reads, the byte permutations, ``__dp4a`` as an integer dot of four
signed bytes and ``mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`` by
PTX's fragment tables for ``.s8``.  Each returns the int64 accumulators
before the epilogue and asserts where the kernel reads (aligned, inside the
input row) and that every output is written once.  The tests hold them
exactly against the JAX package's ``conv_2d_accumulate`` and
``depthwise_conv_2d_accumulate``.  ``fixed_epilogue`` replays the
fixed-point epilogue (``requant="fixed"``) those paths apply to their
accumulators, from the same plan bytes.  ``qgemm_mma`` replays the per-op
GEMM's tensor-core path (``csrc/qgemm.cu``), which shares ``mma.sync`` and
the A fragment order with ``op_pw_mma``, end to end: its in-block fragment
build, B reads, row sums, epilogue and stores.
"""

import os
import re

import numpy as np

from microflow_tpu_torch.core.numerics import np_epilogue, np_round_away
from microflow_tpu_torch.kernels import build
from microflow_tpu_torch.kernels import flatpack as tflat

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



def div16(n, d: int):
    """The kernel's ``Div16``: ``n // d`` as ``(n * M) >> 32`` with
    ``M = ceil(2**32 / d)`` split into a 32-bit ``lo`` and ``hi = d == 1``."""
    lo = np.uint64((0xFFFFFFFF // d + 1) & 0xFFFFFFFF)
    n = np.asarray(n).astype(np.uint64)
    return ((n * lo) >> np.uint64(32)).astype(np.int64) + (n.astype(np.int64) if d == 1 else 0)



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



def op_dw_vec(row, buf, x: np.ndarray) -> np.ndarray:
    """One sample through the kernel's ``op_dw_vec``: descriptor ``row``,
    plan bytes ``buf``, int8 input row ``x`` (C channels, or one that every
    channel reads); returns the int64 accumulators ``[OH*OW, C]`` before the
    epilogue.  Thread t keeps channel group ``t % groups`` and takes pixels
    ``t // groups``, ``+ THREADS // groups``, ...; per four taps it reads
    one word a tap (the group's channels of the pixel, or its one channel
    in all four bytes; ``in_zp`` outside the input; 0 past the last tap),
    transposes them into one word of four taps a channel and multiplies it
    by the plan's word of those taps."""
    ih, iw, ic, oh, ow, c, kh, kw, sr, sc, pt, pl, zp = (int(row[f]) for f in (
        tflat.F_IH, tflat.F_IW, tflat.F_IC, tflat.F_OH, tflat.F_OW, tflat.F_OC, tflat.F_KH,
        tflat.F_KW, tflat.F_SR, tflat.F_SC, tflat.F_PT, tflat.F_PL, tflat.F_ZP))
    taps, groups = kh * kw, c // 4
    n4 = -(-taps // 4)
    zpw = (zp & 0xFF) * 0x01010101
    w = buf[row[tflat.F_W]:row[tflat.F_W] + 16 * n4 * groups].view(np.int32).astype(np.uint32)
    w = w.reshape(n4, c)
    d = buf[row[tflat.F_D]:row[tflat.F_D] + 4 * c].view(np.int32).astype(np.int64)
    g, p = work_items(groups, oh * ow)
    r0, q0 = (p // ow) * sr - pt, (p % ow) * sc - pl
    acc = d.reshape(groups, 4)[g].copy()  # [items, 4]
    for i in range(n4):
        t = []
        for j in range(4):
            tap = 4 * i + j
            if tap >= taps:
                t.append(np.zeros(len(g), np.uint64))
                continue
            r, q = r0 + tap // kw, q0 + tap % kw
            ok = (r >= 0) & (r < ih) & (q >= 0) & (q < iw)
            pix = r * iw + q
            if ic == 1:
                byte = x.view(np.uint8).astype(np.uint64)[np.where(ok, pix, 0)]
                t.append(np.where(ok, byte * np.uint64(0x01010101), np.uint64(zpw)))
            else:
                t.append(read_words(x, pix * ic + 4 * g, ok, (pix - q) * ic, (pix - q + iw) * ic,
                                    zpw))
        # transpose4: word j of channel group's taps -> word of channel j's taps
        tb = np.stack([signed_bytes(v) for v in t], 1)  # [items, tap j, channel]
        for ch in range(4):
            acc[:, ch] += (tb[:, :, ch] * signed_bytes(w[i, 4 * g + ch])).sum(-1)
    out = np.zeros((oh * ow, c), np.int64)
    written = np.zeros((oh * ow, c), np.int64)
    for ch in range(4):
        out[p, 4 * g + ch] = acc[:, ch]
        np.add.at(written, (p, 4 * g + ch), 1)
    assert (written == 1).all()
    assert (np.abs(out) < 2**31).all()
    return out



def fixed_epilogue(row, buf, acc: np.ndarray) -> np.ndarray:
    """The kernels' fixed-point epilogue (``mf_fixed`` in ``csrc/epilogue.cuh``
    through ``Fixed`` and ``epilogue<R_FIXED>`` in ``segment_ops.cuh``) on
    the accumulators ``[..., OC]`` an op path returns (``d`` included):
    ``bias_q`` (i32) and ``m`` (f32) read from the op's ``F_BIAS`` and
    ``F_C1`` words, ``q = acc + bias_q`` wrapped to i32, ``p = f32(q) * m``,
    ``t = p + (p >= 0 ? 0.5 : -0.5)`` clamped to the bounds less ``out_zp``,
    truncated, plus ``out_zp``."""
    assert int(row[tflat.F_EXACT]) == tflat.EPILOGUES["fixed"]
    oc = int(row[tflat.F_OC])
    bias_q = buf[row[tflat.F_BIAS]:row[tflat.F_BIAS] + 4 * oc].view(np.int32).astype(np.int64)
    m = buf[row[tflat.F_C1]:row[tflat.F_C1] + 4 * oc].view(np.float32)
    zp = int(row[tflat.F_OUTZP])
    lo, hi = np.float32(int(row[tflat.F_LO]) - zp), np.float32(int(row[tflat.F_HI]) - zp)
    q = (acc.astype(np.int64) + bias_q + 2**31) % 2**32 - 2**31
    p = (q.astype(np.float32) * m).astype(np.float32)
    t = (p + np.where(p >= 0, np.float32(0.5), np.float32(-0.5))).astype(np.float32)
    return np.trunc(np.minimum(np.maximum(t, lo), hi)).astype(np.int64) + zp


# --- qgemm's tensor-core path (csrc/qgemm.cu, qgemm_mma) ----------------------

def qgemm_constant(name: str) -> int:
    """A ``constexpr int`` of ``csrc/qgemm.cu``, read from the source."""
    with open(os.path.join(build.CSRC, "qgemm.cu")) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


MMA_TILES = qgemm_constant("kTiles")  # tiles of 8 rows a warp's work item
ITEM_ROWS = 8 * MMA_TILES
MAX_MTILES = qgemm_constant("kMaxTiles")  # m-tiles of 16 channels a block
MMA_WARPS = qgemm_constant("kThreads") // 32
MAX_FRAG_BYTES = qgemm_constant("kMaxFragBytes")
MAX_BLOCKS = qgemm_constant("kMaxBlocks")
ONES = np.uint64(0x01010101)


def mma_geometry(M: int, K: int, N: int) -> dict:
    """``launch_mma``'s launch: m-tiles a block (``mt``), column chunks
    (grid x), work items, items a block (``ipb``) and blocks along M."""
    units = -(-K // 32)
    mt = min(-(-N // 16), MAX_MTILES)
    while mt > 1 and mt * units * 512 > MAX_FRAG_BYTES:
        mt -= 1
    chunks = -(-N // (16 * mt))
    items = -(-M // ITEM_ROWS)
    by = min(-(-items // MMA_WARPS), max(MAX_BLOCKS // chunks, 1))
    ipb = -(-(-(-items // by)) // MMA_WARPS) * MMA_WARPS
    return dict(units=units, mt=mt, chunks=chunks, items=items, ipb=ipb,
                by=-(-items // ipb), smem=mt * (units * 512 + 16 * 16))


def transpose4(t: list) -> list:
    """The kernel's ``transpose4`` (``csrc/mma_s8.cuh``) on uint32 arrays."""
    ab_lo, ab_hi = byte_perm(t[0], t[1], 0x5140), byte_perm(t[0], t[1], 0x7362)
    cd_lo, cd_hi = byte_perm(t[2], t[3], 0x5140), byte_perm(t[2], t[3], 0x7362)
    return [byte_perm(ab_lo, cd_lo, 0x5410), byte_perm(ab_lo, cd_lo, 0x7632),
            byte_perm(ab_hi, cd_hi, 0x5410), byte_perm(ab_hi, cd_hi, 0x7632)]


def mma_fragment_build(w: np.ndarray, n0: int, mt: int) -> np.ndarray:
    """The block's in-kernel build of its A fragments from int8 ``w [K, N]``
    for output channels ``n0 .. n0 + 16*mt - 1``: every thread-iteration
    ``e`` reads rows c..c+3 at columns n..n+3, transposes the 4x4 bytes and
    stores each column's word at its lane and register.  Returns the int8
    bytes ``[mt, units, 32 lanes, 16]``; asserts every word is stored once."""
    K, N = w.shape
    units, quads = -(-K // 32), 4 * mt
    e = np.arange(units * 8 * quads)
    nq, c = e % quads, 4 * (e // quads)
    n = n0 + 4 * nq
    wb = w.view(np.uint8).astype(np.uint64)
    rows = []
    for r in range(4):
        v = np.zeros(len(e), np.uint64)
        for b in range(4):
            ok = (c + r < K) & (n + b < N)
            v |= np.where(ok, wb[np.minimum(c + r, K - 1), np.minimum(n + b, N - 1)], 0) << \
                np.uint64(8 * b)
        rows.append(v)
    cols = transpose4(rows)
    kb = c & ~63
    off = c - kb
    pair = K - kb > 32
    unit = (kb >> 5) + np.where(pair, (off >> 3) & 1, 0)
    lane_t = np.where(pair, off >> 4, off >> 3)
    half = (off >> 2) & 1
    fw = np.zeros(mt * units * 32 * 4, np.uint32)
    stored = np.zeros(len(fw), np.int64)
    for b in range(4):
        r = 4 * nq + b
        idx = (((r >> 4) * units + unit) * 32 + 4 * (r & 7) + lane_t) * 4 + 2 * half + ((r >> 3) & 1)
        fw[idx] = cols[b]
        np.add.at(stored, idx, 1)
    assert (stored == 1).all()
    return fw.view(np.int8).reshape(mt, units, 32, 16)


def mma_load_b(xb: np.ndarray, rows: np.ndarray, ok: np.ndarray, kb: int, K: int,
               vec: int) -> np.ndarray:
    """``load_b<vec>`` for one tile: the uint32 B words ``[32 lanes, 4]`` of
    channels kb.. of row ``rows`` (lane 4g + t reads row g's); 0 past K
    and for absent rows (``ok`` False).  Asserts what each vector load
    assumes."""
    pair = K - kb > 32
    nw = 4 if pair else 2
    c = kb + (16 if pair else 8) * T
    live = ok & (c < K)
    if vec == 2:  # one 16- or 8-byte load, aligned, wholly inside the row
        assert ((rows * K + c)[live] % (4 * nw) == 0).all() and (c[live] + 4 * nw <= K).all()
    words = np.zeros((32, 4), np.uint64)
    for i in range(nw):
        if vec == 1:  # whole aligned words
            assert ((rows * K + c + 4 * i)[live & (c + 4 * i < K)] % 4 == 0).all()
            assert (c + 4 * i + 4 <= K)[live & (c + 4 * i < K)].all()
        for b in range(4):
            ch = c + 4 * i + b
            read = live & (ch < K)
            words[:, i] |= np.where(read, xb[np.where(read, rows * K + ch, 0)], 0) << \
                np.uint64(8 * b)
    return words


def word_bytes(words: np.ndarray) -> np.ndarray:
    """uint32 words ``[32, n]`` as their signed bytes ``[32, 4n]``."""
    return signed_bytes(words).reshape(32, -1)


def qgemm_mma(x, w, wzp, d, bias0, c1, lo: int, hi: int, vec: int = 2,
              vec_out: bool = True) -> np.ndarray:
    """int8 ``[M, N]`` by ``qgemm_mma``'s steps: per column chunk the
    fragment build, per block and warp its work items, per tile the B
    reads (with the K permutation), ``mma.sync`` by PTX's fragment tables
    for every live m-tile, the row sums by ``__dp4a`` against ones and the
    quad and pair shuffles, the epilogue, and the stores (the 4x4 byte
    transpose over lanes where ``vec_out``, else byte stores).  Asserts
    every output is stored once."""
    M, K = x.shape
    N = w.shape[1]
    geo = mma_geometry(M, K, N)
    mt = geo["mt"]
    xb = x.view(np.uint8).reshape(-1).astype(np.uint64)
    out = np.zeros((M, N), np.int64)
    stored = np.zeros((M, N), np.int64)
    lo32, hi32 = np.float32(lo), np.float32(hi)

    def requant(acc, rs, z, dd, b0, cc):
        q = acc - rs * z + dd
        assert (np.abs(q) < 2**31).all()
        y, _ = np_epilogue(cc, q.astype(np.float32), b0)
        return (np.clip(np_round_away(y), lo32, hi32).astype(np.int64) & 0xFF).astype(np.uint64)

    for chunk in range(geo["chunks"]):
        n0 = chunk * 16 * mt
        live = min(mt, -(-(N - n0) // 16))
        frag = mma_fragment_build(w, n0, mt).astype(np.int64)
        ch = n0 + np.arange(16 * mt)
        consts = [np.where(ch < N, a[np.minimum(ch, N - 1)], 0) for a in (wzp, d, bias0, c1)]
        for blk in range(geo["by"]):
            first = blk * geo["ipb"]
            last = min(first + geo["ipb"], geo["items"])
            for warp in range(MMA_WARPS):
                for item in range(first + warp, last, MMA_WARPS):
                    p0 = item * ITEM_ROWS
                    for j in range(MMA_TILES):
                        rows = p0 + 8 * j + G
                        ok = rows < M
                        acc = np.zeros((live, 32, 4), np.int64)
                        rs = np.zeros(32, np.int64)
                        for kb in range(0, K, 64):
                            cur = mma_load_b(xb, rows, ok, kb, K, vec)
                            for i in range(4):
                                rs = dp4a(cur[:, i], ONES, rs)
                            for m in range(live):
                                mma(acc[m], frag[m, kb // 32], word_bytes(cur[:, :2]))
                                if K - kb > 32:
                                    mma(acc[m], frag[m, kb // 32 + 1], word_bytes(cur[:, 2:]))
                        r = rs + rs[LANE ^ 1]
                        r = r + r[LANE ^ 2]
                        r0, r1 = r[8 * T], r[8 * T + 4]
                        p = p0 + 8 * j + 2 * T
                        for m in range(live):
                            nm = n0 + 16 * m
                            na, nb = nm + G, nm + G + 8
                            ka = [c[16 * m + G] for c in consts]
                            kb_ = [c[16 * m + G + 8] for c in consts]
                            v = [requant(acc[m][:, 0], r0, *ka), requant(acc[m][:, 1], r1, *ka),
                                 requant(acc[m][:, 2], r0, *kb_), requant(acc[m][:, 3], r1, *kb_)]
                            if vec_out:
                                i = G & 3
                                word = v[0] | v[1] << np.uint64(8) | v[2] << np.uint64(16) | \
                                    v[3] << np.uint64(24)
                                y = word[LANE ^ 8]
                                u = np.where(i & 2, byte_perm(y, word, 0x7632),
                                             byte_perm(word, y, 0x5410))
                                y = u[LANE ^ 4]
                                word = np.where(i & 1, byte_perm(u, y, 0x3715),
                                                byte_perm(u, y, 0x6240))
                                pr, n = p + (i & 1), nm + 4 * (G >> 2) + 8 * (i >> 1)
                                keep = (pr < M) & (n < N)
                                assert (n[keep] % 4 == 0).all() and (n[keep] + 4 <= N).all()
                                vals = signed_bytes(word)
                                for b in range(4):
                                    out[pr[keep], n[keep] + b] = vals[keep, b]
                                    np.add.at(stored, (pr[keep], n[keep] + b), 1)
                            else:
                                for pr, n, val in ((p, na, v[0]), (p + 1, na, v[1]),
                                                   (p, nb, v[2]), (p + 1, nb, v[3])):
                                    keep = (pr < M) & (n < N)
                                    out[pr[keep], n[keep]] = signed_bytes(val)[keep, 0]
                                    np.add.at(stored, (pr[keep], n[keep]), 1)
    assert (stored == 1).all()
    return out.astype(np.int8)


# --- qgemm's narrow path (csrc/qgemm.cu, qgemm_rows) ---------------------------

ROW_COLS = qgemm_constant("kCols")  # output columns a lane
ROW_CHUNK = qgemm_constant("kChunk")  # output columns a block
ROW_STRIDE = qgemm_constant("kStride")  # words a staged row of W or constants
ROW_ROWS = qgemm_constant("kRows")  # rows a thread per work item, K <= 8
ROW_ROWS_WIDE = qgemm_constant("kRowsWide")  # the same, 8 < K <= 32
THREADS = qgemm_constant("kThreads")
HALF_DOWN = np.uint32(0x3EFFFFFF).view(np.float32)  # 0.5 - 2**-25


def rows_geometry(M: int, K: int, N: int, blocks: int) -> dict:
    """``launch_narrow``/``launch_rows``' launch for ``blocks`` resident
    blocks: words of K a row (``kw``), rows a thread (``rows``), lanes a
    row (``lanes``), rows a tile (``tile``), column chunks (grid y), work
    items and blocks along the rows (grid x)."""
    kw = next(v for v in (1, 2, 4, 8, 16) if 4 * v >= K)
    rows = ROW_ROWS if kw <= 2 else ROW_ROWS_WIDE if kw <= 8 else 1
    span, lanes_log2 = min(N, ROW_CHUNK), 0
    while ROW_COLS << lanes_log2 < span:
        lanes_log2 += 1
    tile = 32 >> lanes_log2
    chunks = -(-N // ROW_CHUNK)
    items = -(-M // (rows * tile))
    warps = THREADS // 32
    bx = min(max(blocks // chunks, 1), -(-items // warps))
    return dict(kw=kw, rows=rows, lanes=1 << lanes_log2, tile=tile, chunks=chunks, items=items,
                bx=bx)


def rows_items(geo: dict) -> np.ndarray:
    """The work items in the order the warps take them: warp w of block b
    starts at ``b * warps + w`` and strides by ``bx * warps``.  Returns
    ``[n, 2]`` (global warp, item) pairs."""
    warps = THREADS // 32
    step = geo["bx"] * warps
    gw = np.arange(step)
    per = np.maximum(-(-(geo["items"] - gw) // step), 0)  # items warp gw takes
    warp = np.repeat(gw, per)
    k = np.arange(len(warp)) - np.repeat(np.cumsum(per) - per, per)
    return np.stack([warp, warp + k * step], 1)


def row_position(c):
    """The staged word of chunk column ``c``: 4 words of padding after every 32."""
    return c + 4 * (np.asarray(c) >> 5)


def rows_stage(w, wzp, d, bias0, c1, n0: int, kw: int) -> np.ndarray:
    """A block's shared memory for columns ``n0 ..``: rows 0 .. kw-1 the W
    words (column n's bytes k = 4i .. 4i+3 in row i), then -wzp, d, bias0
    and c1, column c at ``row_position(c)``; columns past N 0.  Asserts
    each live word is written once and no padding word is."""
    K, N = w.shape
    sm = np.zeros((kw + 4, ROW_STRIDE), np.uint32)
    hits = np.zeros(sm.shape, np.int64)
    c = np.arange(ROW_CHUNK)
    n = n0 + c
    live = n < N
    ns = np.minimum(n, N - 1)
    wb = w.view(np.uint8).astype(np.uint64)
    pos = row_position(c)
    for i in range(kw):
        v = np.zeros(ROW_CHUNK, np.uint64)
        for b in range(4):
            if 4 * i + b < K:
                v |= np.where(live, wb[4 * i + b, ns], 0) << np.uint64(8 * b)
        sm[i, pos] = v.astype(np.uint32)
    for r, a in ((kw, -wzp.astype(np.int64)), (kw + 1, d.astype(np.int64))):
        sm[r, pos] = (np.where(live, a[ns], 0) & 0xFFFFFFFF).astype(np.uint32)
    sm[kw + 2, pos] = np.where(live, bias0[ns], np.float32(0)).astype(np.float32).view(np.uint32)
    sm[kw + 3, pos] = np.where(live, c1[ns], np.float32(0)).astype(np.float32).view(np.uint32)
    hits[:, pos] += 1
    assert (hits.sum(1) == ROW_CHUNK).all() and hits.max() == 1
    return sm


def round_requant(q, bias0, c1, lo, hi) -> np.ndarray:
    """``round_byte``: y = bias0 + c1 * f32(q) (the multiply, then the add)
    clamped to [lo, hi], then ``trunc(y + copysign(0.5 - 2**-25, y))``;
    the output bytes (uint8)."""
    y, _ = np_epilogue(c1, np.asarray(q).astype(np.float32), bias0)
    y = np.minimum(np.maximum(y, np.float32(lo)), np.float32(hi)).astype(np.float32)
    t = (y + np.copysign(HALF_DOWN, y)).astype(np.float32)
    return (np.trunc(t).astype(np.int64) & 0xFF).astype(np.uint8)


def qgemm_rows(x, w, wzp, d, bias0, c1, lo: int, hi: int, *, blocks: int, x_off: int = 0,
               out_off: int = 0) -> np.ndarray:
    """int8 ``[M, N]`` by ``qgemm_rows``' steps, X at ``x_off`` and the
    output at ``out_off`` bytes past a 16-byte aligned address, on a grid
    of ``blocks`` resident blocks: per column chunk the staged shared
    memory; per warp its work items in grid-stride order; per lane its rows
    (``item * rows * tile + g + tile * j``) read in the entry point's mode
    (vector, words or bytes; each vector and word read asserted aligned),
    ``__dp4a`` against the staged W words and against ones, every group of
    four columns computed, the epilogue (``round_requant``) and the stores
    in their mode (alignment asserted).  Asserts every output is stored
    once."""
    M, K = x.shape
    N = w.shape[1]
    geo = rows_geometry(M, K, N, blocks)
    kw, R, L, tile = geo["kw"], geo["rows"], geo["lanes"], geo["tile"]
    vec = 4 * kw if kw < 4 else 16
    x_mode = 2 if K == 4 * kw and x_off % vec == 0 else 1 if K % 4 == 0 and x_off % 4 == 0 else 0
    out_mode = (2 if N % ROW_COLS == 0 and out_off % ROW_COLS == 0
                else 1 if N % 4 == 0 and out_off % 4 == 0 else 0)
    xb = x.view(np.uint8).reshape(-1).astype(np.uint64)
    lane = np.arange(32)
    s, g = lane % L, lane // L
    pairs = rows_items(geo)
    # rows [n_items, 32 lanes, R]
    rows = (pairs[:, 1, None, None] * R * tile + g[None, :, None]
            + tile * np.arange(R)[None, None, :])
    ok = rows < M
    words = np.zeros(rows.shape + (kw,), np.uint64)
    for i in range(kw):
        for b in range(4):
            if 4 * i + b < K:
                words[..., i] |= np.where(ok, xb[np.where(ok, rows * K + 4 * i + b, 0)], 0) << \
                    np.uint64(8 * b)
    addr = x_off + rows * K
    if x_mode:
        assert (addr[ok] % (vec if x_mode == 2 else 4) == 0).all()
    out = np.zeros((M, N), np.int64)
    stored = np.zeros((M, N), np.int64)
    rs = np.zeros(rows.shape, np.int64)
    for i in range(kw):
        rs = dp4a(words[..., i], np.full(rows.shape, ONES, np.uint64), rs)
    for chunk in range(geo["chunks"]):
        n0 = chunk * ROW_CHUNK
        sm = rows_stage(w, wzp, d, bias0, c1, n0, kw)
        cb = ROW_COLS * s
        live = np.minimum(ROW_COLS, N - n0 - cb)  # per lane
        for col in range(ROW_COLS):
            pos = row_position(cb + col)
            acc = np.broadcast_to(sm[kw + 1, pos].view(np.int32).astype(np.int64)[None, :, None],
                                  rows.shape).copy()
            for i in range(kw):
                acc = dp4a(words[..., i], np.broadcast_to(sm[i, pos][None, :, None], rows.shape),
                           acc)
            q = acc + rs * sm[kw, pos].view(np.int32).astype(np.int64)[None, :, None]
            byte = round_requant(q.astype(np.int32), sm[kw + 2, pos].view(np.float32)[None, :, None],
                                 sm[kw + 3, pos].view(np.float32)[None, :, None], lo, hi)
            n = np.broadcast_to((n0 + cb + col)[None, :, None], rows.shape)
            keep = ok & (live > col)[None, :, None]
            out[rows[keep], n[keep]] = byte[keep].astype(np.int8)
            np.add.at(stored, (rows[keep], n[keep]), 1)
        # stores: the alignment of each lane's store in its mode
        o = out_off + rows * N + n0 + cb[None, :, None]
        st = ok & (live > 0)[None, :, None]
        if out_mode == 2:
            assert (o[st] % ROW_COLS == 0).all() and (live[live > 0] == ROW_COLS).all()
        elif out_mode == 1:
            assert (o[st] % 4 == 0).all() and (live[live > 0] % 4 == 0).all()
    assert (stored == 1).all()
    return out.astype(np.int8)


# --- the column-FC kernel (csrc/colfc.cu, col_kernel) ---------------------------

def colfc_constant(name: str) -> int:
    """A ``constexpr int`` of ``csrc/colfc.cu``, read from the source."""
    with open(os.path.join(build.CSRC, "colfc.cu")) as f:
        return int(re.search(rf"constexpr int {name} = (0x[0-9A-Fa-f]+|\d+);", f.read()).group(1),
                   0)


COL_TILES = colfc_constant("kTilesWarp")  # m-tiles of 16 samples a warp's work item
COL_HEADER = colfc_constant("kHeader")  # words a layer's header
COL_NARROW_IN = colfc_constant("kNarrowIn")  # K0 up to which a lane reads whole rows
COL_NARROW_OUT = colfc_constant("kNarrowOut")  # N_out up to which a lane writes whole rows
def exact2_int(acc, b0, c1, lo, hi) -> np.ndarray:
    """The kernel's ``exact2_int``: y = b0 + c1 * f32(acc) (the multiply,
    then the add), t = y + copysign(0.5, y), clamped to [lo, hi] only where
    the bounds are tighter than int8's, truncated to int32
    (``__float2int_rz`` saturates)."""
    f = np.asarray(acc, np.int64).astype(np.float32)
    y = (np.float32(b0) + (np.float32(c1) * f).astype(np.float32)).astype(np.float32)
    t = (y + np.copysign(np.float32(0.5), y)).astype(np.float32)
    if lo > -128 or hi < 127:
        t = np.minimum(np.maximum(t, np.float32(lo)), np.float32(hi))
    return np.trunc(np.clip(t.astype(np.float64), -2.0**31, 2.0**31 - 1)).astype(np.int64)


def pack_s8(a, b, c) -> np.ndarray:
    """``cvt.pack.sat.s8.s32.b32``: (c << 16) | (sat8(a) << 8) | sat8(b),
    uint64 words of 32 bits."""
    sat = lambda v: np.clip(v, -128, 127).astype(np.int64) & 0xFF
    return (((np.asarray(c, np.uint64) & np.uint64(0xFFFF)) << np.uint64(16))
            | (sat(a).astype(np.uint64) << np.uint64(8)) | sat(b).astype(np.uint64))


def mma_tiles(acc: np.ndarray, a: np.ndarray, b: np.ndarray) -> None:
    """``mma_s8`` on every m-tile at once: ``acc [T, 32 lanes, 4] += A x B``,
    A from the A registers ``a [T, 32, 4]`` (uint32 words), B from the B
    registers ``b [32, 2]``, by PTX's fragment tables."""
    A = np.zeros((a.shape[0], 16, 32), np.int64)
    A[:, A_ROW, A_COL] = signed_bytes(a).reshape(a.shape[0], 32, 16)
    B = np.zeros((32, 8), np.int64)
    B[B_ROW, B_COL] = signed_bytes(b).reshape(32, 8)
    acc += (A @ B)[:, D_ROW, D_COL]


def pack_tiles(q: dict, nt: int) -> np.ndarray:
    """The next layer's A registers ``[T, 32, 4]`` from each n-tile j's four
    epilogue outputs a lane ``q[j] [T, 32, 4]`` (C registers: (g, 8j+2t),
    (g, 8j+2t+1), (g+8, ..)), as ``run_layer`` packs them: registers
    2*(j//2) (row g) and 2*(j//2)+1 (row g+8) get the even n-tile's pair
    (``pack_s8``), shifted to the high half by the odd n-tile's
    ``pack_s8`` or, for a last even n-tile, by 16 bits; registers 2-3 zero
    where nt <= 2."""
    first = q[0]
    na = np.zeros(first.shape[:2] + (4,), np.uint64)
    for j in range(nt):
        r = 2 * (j >> 1)
        for s in range(2):
            pair = (q[j][..., 2 * s + 1], q[j][..., 2 * s])
            if j & 1:
                na[..., r + s] = pack_s8(*pair, na[..., r + s])
            elif j + 1 < nt:
                na[..., r + s] = pack_s8(*pair, 0)
            else:
                na[..., r + s] = (pack_s8(*pair, 0) << np.uint64(16)) & np.uint64(0xFFFFFFFF)
    return na


def colfc_mma(buf: np.ndarray, x: np.ndarray, n_layers: int, n_out: int, *, x_off: int = 0,
              out_off: int = 0) -> np.ndarray:
    """int8 ``[B, N_out]`` by ``col_kernel``'s steps, x at ``x_off`` and the
    output at ``out_off`` bytes past an aligned address, from the packed
    plan ``buf`` (``kernels/colfc.py::pack_col_plan``) read as the kernel
    reads it.  The m-tiles of every work item at once: lane 4g+t's rows r =
    item * 16 * kTilesWarp + 16m + g and r + 8.  Its A registers: for K0 <=
    kNarrowIn, lane i of the warp reads rows i, i + 32, .. of the item
    whole (a word where K0 == 4 and x is aligned, else bytes) and lanes
    t == 0 take rows g and g + 8 from lane (16m + 8s + g) % 32 by shuffles;
    else each lane reads its own in words (K0 % 4 == 0 and x aligned; each
    word asserted aligned) or bytes, zero past K0 and past B.  Per layer its
    header, its B fragment words, d, bias0 and c1 of columns
    8j+2t and 8j+2t+1 per n-tile j, ``mma_s8``, ``exact2_int`` of each C
    register and the packing into the next A (``pack_tiles``).  For N_out
    <= kNarrowOut the last layer (its columns repeated by the plan) keeps
    one C register a lane, register t of lane 4g+t, and lane i gathers row
    16m + 8s + g's columns from lanes 4g + 2s and 4g + 2s + 1 and writes
    it whole (a pair where N_out is 2 and out is aligned; asserted); else
    each lane writes its features in pairs (N_out even and out aligned;
    asserted) or bytes.  Asserts no
    accumulator leaves int32 and every output is stored once."""
    B, k0 = x.shape
    header = buf[:n_layers * COL_HEADER].reshape(n_layers, COL_HEADER)
    rows_item = 16 * COL_TILES
    items = -(-B // rows_item)
    r = np.arange(items * COL_TILES)[:, None] * 16 + G[None, :]
    rows = np.stack([r, r + 8], -1)  # [T, 32 lanes, 2]: rows g and g + 8
    ok = rows < B
    words = k0 % 4 == 0 and x_off % 4 == 0
    xb = x.view(np.uint8).reshape(-1).astype(np.uint64)
    a = np.zeros(r.shape + (4,), np.uint64)

    def read_row(row, live, n):  # bytes 0 .. n-1 of each live row, as words
        addr = row * k0
        if words:
            assert ((x_off + addr)[live] % 4 == 0).all()
        v = np.zeros(row.shape, np.uint64)
        for i in range(n):
            li = live & (i < k0)
            v |= np.where(li, xb[np.where(li, addr + i, 0)], 0) << np.uint64(8 * i)
        return v

    if k0 <= COL_NARROW_IN:
        # lane i's rows i + 32u of each item, then the shuffles
        lanes = np.arange(-(-rows_item // 32) * 32)
        item_rows = np.arange(items)[:, None] * rows_item + lanes[None, :]
        live = (item_rows < B) & (lanes[None, :] < rows_item)
        v = read_row(item_rows, live, COL_NARROW_IN)  # [items, lanes]
        m_tile = np.arange(items * COL_TILES)
        for s in range(2):
            src = (16 * (m_tile % COL_TILES))[:, None] + 8 * s + G[None, :]  # row in the item
            got = v[(m_tile // COL_TILES)[:, None], src]
            a[..., s] = np.where(T[None, :] == 0, got, 0)
    else:
        for h in range(2):
            if 16 * h >= k0:
                break
            k = 16 * h + 4 * T
            for s in range(2):
                live = ok[..., s] & (k < k0)[None, :]
                addr = rows[..., s] * k0 + k[None, :]
                if words:
                    assert ((x_off + addr)[live] % 4 == 0).all()
                for i in range(min(4, k0)):
                    li = live & (k + i < k0)[None, :]
                    a[..., 2 * h + s] |= np.where(li, xb[np.where(li, addr + i, 0)], 0) << \
                        np.uint64(8 * i)
    narrow_out = n_out <= COL_NARROW_OUT
    for li, (nt, lo, hi, off) in enumerate(header):
        lo, hi = np.int32(lo).view(np.float32), np.int32(hi).view(np.float32)
        q = {}
        for j in range(nt):
            b = buf[off + 2 * (32 * j + LANE)[:, None] + np.arange(2)].view(np.uint32)
            col = 8 * j + 2 * T[:, None] + np.arange(2)  # [32, 2]: columns 8j+2t, +1
            d = buf[off + 64 * nt + col].astype(np.int64)
            b0 = buf[off + 72 * nt + col].view(np.float32)
            c1 = buf[off + 80 * nt + col].view(np.float32)
            acc = np.broadcast_to(d[:, [0, 1, 0, 1]], a.shape).copy()
            mma_tiles(acc, a, b)
            assert (acc >= -2**31).all() and (acc < 2**31).all()
            if narrow_out and li == n_layers - 1:
                # run_last_narrow: lane t keeps C register t, column 2t + t%2
                assert nt == 1
                keep = acc[:, LANE, T]
                last = exact2_int(keep, b0[LANE, T & 1], c1[LANE, T & 1], lo, hi)  # [T, 32]
                break
            q[j] = exact2_int(acc, b0[:, [0, 1, 0, 1]], c1[:, [0, 1, 0, 1]], lo, hi)
        else:
            a = pack_tiles(q, nt)
    out = np.zeros((B, n_out), np.int64)
    stored = np.zeros((B, n_out), np.int64)
    if narrow_out:
        # store_narrow: lane i of item it writes row it * rows_item + i + 32u
        # (row 16m + 8s + g of the item), column e from lane 4g + 2s + e
        pairs = n_out == 2 and out_off % 2 == 0
        lanes = np.arange(-(-rows_item // 32) * 32)
        m, s = lanes // 16, (lanes // 8) % 2
        src = 4 * (lanes % 8) + 2 * s
        for it in range(items):
            row = it * rows_item + lanes
            live = (row < B) & (m < COL_TILES)
            mt = it * COL_TILES + np.minimum(m, COL_TILES - 1)
            v = pack_s8(last[mt, src + 1], last[mt, src], 0)
            if pairs:
                assert ((out_off + row * n_out)[live] % 2 == 0).all()
            for e in range(n_out):
                out[row[live], e] = (v[live] >> np.uint64(8 * e)) & np.uint64(0xFF)
                np.add.at(stored, (row[live], e), 1)
    else:
        pairs = n_out % 2 == 0 and out_off % 2 == 0
        for s in range(2):
            for q4 in range(4):
                if 8 * q4 >= n_out:
                    break
                c = np.broadcast_to((8 * q4 + 2 * T)[None, :], r.shape)
                v = a[..., 2 * (q4 >> 1) + s] >> np.uint64(0 if q4 & 1 else 16)
                if pairs:
                    live = ok[..., s] & (c < n_out)
                    assert ((out_off + rows[..., s] * n_out + c)[live] % 2 == 0).all()
                for e in range(2):
                    live = ok[..., s] & (c + e < n_out)
                    out[rows[..., s][live], (c + e)[live]] = (v[live] >> np.uint64(8 * e)) & \
                        np.uint64(0xFF)
                    np.add.at(stored, (rows[..., s][live], (c + e)[live]), 1)
    assert (stored == 1).all()
    return out.astype(np.uint8).view(np.int8)
