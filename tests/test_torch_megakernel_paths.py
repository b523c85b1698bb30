"""The megakernel's shared op paths on the CPU: which path the plan
(``kernels/megakernel.py::pack_segment``) gives each op, and the numpy
emulators of ``op_pw_mma``, ``op_dw3``/``op_dw3_stem`` and ``op_dw_vec``
(``tests/torch_emulators.py``, the same ones that hold the flat kernel)
replayed on the descriptors and bytes that plan writes.

The emulated int32 accumulators must equal exactly the JAX package's
``conv_2d_accumulate`` / ``depthwise_conv_2d_accumulate`` with the layer's
own weight zero points: on every such op of person_detect, on the edge
graphs of ``chip_smoke.py``, and on depthwise ops with nonzero per-channel
``w_zp`` whose centred taps ``w - w_zp`` fit int8.  Ops whose centred taps
do not fit int8, and 1x1 convs with a nonzero ``w_zp``, keep the general
paths.
"""

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch_parity as tp
from torch_emulators import op_dw3, op_dw_vec, op_pw_mma

from microflow_tpu.ops.conv_2d import conv_2d_accumulate
from microflow_tpu.ops.depthwise_conv_2d import depthwise_conv_2d_accumulate
from microflow_tpu_torch.core.numerics import broadcast_per_channel
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.kernels import build_fused_forward
from microflow_tpu_torch.kernels import flatpack as tflat
from microflow_tpu_torch.kernels import megakernel as tmega
from microflow_tpu_torch.models import model_path

PD_FUSED = (["dw3_stem", "dw3_s1"] + [p for s in (2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 2, 1)
                                      for p in ("pw_mma", f"dw3_s{s}")]
            + ["pw_mma", "pool", "pw"])
PATHS = {
    # 14 depthwise ops on the strips, 13 1x1 convs on the tensor cores, the
    # 2-channel head on op_pw
    ("person_detect", 0): PD_FUSED,
    ("person_detect", 9): PD_FUSED[9:],
    ("speech", 0): ["dw_vec", "fc"],  # the 10x8 stem from one channel
    ("sine", 0): ["fc", "fc", "fc"],
    # nonzero w_zp on the 3x3/s2 conv, the 5-channel depthwise conv after it,
    # the 1x1 conv to 12 and the FC
    ("conv_graph_wzp", 0): ["quantize", "dw", "conv", "dw", "dw", "conv", "dw3_s1", "pw", "pw",
                            "pool", "fc"],
    ("pw_edge_graph", 0): ["pw_mma", "pw", "pw_mma", "pw", "pw_mma", "dw_vec", "pw_mma",
                           "pw_mma", "dw_vec", "pw_mma", "pool", "pw_mma", "pw_mma"],
    ("dw_edge_graph", 0): ["dw3_stem", "dw3_s1", "dw3_s2", "pw", "dw3_s1", "dw3_s2", "pw_mma",
                           "dw3_s1", "dw3_s2", "dw3_s1"],
    ("dw_edge_graph_wzp", 0): chip_smoke.DW_EDGE_WZP_PATHS,
}
EMULATORS = {"pw_mma": op_pw_mma, "dw3_s1": op_dw3, "dw3_s2": op_dw3, "dw3_stem": op_dw3,
             "dw_vec": op_dw_vec}


def _graph(name):
    if name == "conv_graph_wzp":
        return chip_smoke.conv_graph(np.random.default_rng(0), wzp=True)
    if name == "pw_edge_graph":
        return chip_smoke.pw_edge_graph(np.random.default_rng(0))
    if name.startswith("dw_edge_graph"):
        return chip_smoke.dw_edge_graph(np.random.default_rng(0), wzp=name.endswith("wzp"))
    return tparse(model_path(name))


def _plan(segment):
    """The plan bytes of a segment and its descriptors ``[n_ops, NF]``."""
    buf, _, _ = tmega.pack_segment(segment)
    return buf, buf[:len(segment.layers) * tmega.NF * 4].view(np.int32).reshape(-1, tmega.NF)


def _ops(name, start=0):
    """Every op of the graph's fused (``start`` 0) or hybrid segments:
    (layer, in_shape, path, descriptor, plan bytes)."""
    out = []
    for seg in build_fused_forward(_graph(name), start, device="cpu").segments:
        buf, desc = _plan(seg.segment)
        assert [tmega.op_path(row) for row in desc] == seg.paths
        out += [(layer, shp[0], path, row, buf) for layer, shp, path, row
                in zip(seg.segment.layers, seg.segment.shapes, seg.paths, desc)]
    return out


def _wzp(layer):
    n = layer.filters.shape[0] if hasattr(layer, "filters") else layer.weights.shape[-1]
    return broadcast_per_channel(layer.w_q.zero_point, n, np.int64)


@pytest.mark.parametrize("name,start", list(PATHS))
def test_which_path_each_op_takes(name, start):
    ops = _ops(name, start)
    assert [path for _, _, path, _, _ in ops] == PATHS[name, start]
    for layer, _, path, row, _ in ops:
        assert row[tmega.F_EXACT] == 1  # every requant rounds half away from zero
        if path == "pw_mma":  # the tensor cores take no weight zero point
            assert not _wzp(layer).any()
        if path in EMULATORS and path != "pw_mma":  # int8 centred taps
            wc = layer.weights.astype(np.int64) - _wzp(layer)
            assert wc.min() >= -128 and wc.max() <= 127
        if path in ("dw", "pw", "conv"):
            assert not (row[tmega.F_MMA] or row[tmega.F_DW3] or row[tmega.F_VEC])


def _oracle(layer, x, in_shape):
    """The JAX package's exact int32 accumulators of a conv or depthwise
    layer with its own weight zero points; a depthwise input of fewer
    channels than the layer has goes through the channel gather first."""
    geom = tp.jax_graph(layer.geom)
    if hasattr(layer, "filters"):
        return conv_2d_accumulate(jnp.asarray(x), jnp.asarray(layer.filters), geom,
                                  layer.in_q.zp0, _wzp(layer))
    c = layer.weights.shape[2]
    if in_shape[2] != c:
        x = x[..., [ch if ch < in_shape[2] else 0 for ch in range(c)]]
    return depthwise_conv_2d_accumulate(jnp.asarray(x), jnp.asarray(layer.weights), geom,
                                        layer.in_q.zp0, _wzp(layer))


CASES = [(name, i) for name in ("person_detect", "pw_edge_graph", "dw_edge_graph",
                                "dw_edge_graph_wzp", "speech")
         for i, (_, _, path, _, _) in enumerate(_ops(name)) if path in EMULATORS]


@pytest.mark.parametrize("name,i", CASES)
def test_emulated_paths_equal_oracle_accumulators(name, i):
    """Each op on a shared path, replayed by its emulator on the plan the
    megakernel gets, gives exactly the JAX accumulators (with ``w_zp``):
    person_detect's 27 ops, the edge graphs', and speech's stem."""
    layer, in_shape, path, row, buf = _ops(name)[i]
    rng = np.random.default_rng(i)
    x = rng.integers(-128, 128, (2, *in_shape), dtype=np.int8)
    x.flat[:2] = (-128, 127)
    want = np.asarray(_oracle(layer, x, in_shape))
    assert want.dtype == np.int32
    for b in range(2):
        got = EMULATORS[path](row, buf, x[b].reshape(-1))
        assert np.array_equal(got, want[b].reshape(got.shape).astype(np.int64))


def test_the_cases_cover_every_shared_path():
    assert len([c for c in CASES if c[0] == "person_detect"]) == 27
    paths = {_ops(name)[i][2] for name, i in CASES}
    assert paths == set(EMULATORS)
    wzp = [i for name, i in CASES if name == "dw_edge_graph_wzp"
           if _wzp(_ops(name)[i][0]).any()]
    assert len(wzp) == 7  # the strips with nonzero per-channel w_zp


def test_shared_paths_get_the_flat_plans_constants():
    """person_detect (every w_zp 0): each op on a shared path gets the same
    weight words, offsets and epilogue constants in the megakernel's plan as
    in the flat kernel's, which the card holds bit-exact."""
    ops, _, _ = tflat.plan_flat(tparse(model_path("person_detect")))
    fbuf, _ = tflat.pack_plan(ops, "exact")
    fdesc = fbuf[:len(ops) * tflat.NF * 4].view(np.int32).reshape(-1, tflat.NF)
    mega = _ops("person_detect")
    flat = {op.layer_idx: row for op, row in zip(ops, fdesc)}
    fields = [tflat.F_W, tflat.F_D, tflat.F_BIAS, tflat.F_C1, tflat.F_RECIP]
    starts = sorted({int(v) for v in fdesc[:, fields].reshape(-1) if v} | {len(fbuf)})
    n = 0
    for layer, _, path, row, buf in mega:
        if path not in EMULATORS:
            continue
        frow = flat[layer.index]
        for fld in (tflat.F_KIND, tflat.F_DW3, tflat.F_VEC, tflat.F_MMA, tflat.F_EXACT,
                    tflat.F_ZP, tflat.F_LO, tflat.F_HI):
            assert row[fld] == frow[fld]
        for fld in fields[:4]:  # each constant, to where the flat plan's next one starts
            size = starts[starts.index(frow[fld]) + 1] - frow[fld]
            assert np.array_equal(buf[row[fld]:row[fld] + size],
                                  fbuf[frow[fld]:frow[fld] + size])
        n += 1
    assert n == 27


def _one_layer_segment(layer, in_shape):
    return tmega.Segment([layer], tuple(in_shape), tuple(layer.out_shape), None,
                         [(tuple(in_shape), tuple(layer.out_shape))])


@pytest.mark.parametrize("centred,path", [(-128, "dw3_s1"), (127, "dw3_s1"), (-129, "dw"),
                                          (128, "dw"), (255, "dw"), (-255, "dw")])
def test_strips_need_int8_centred_taps(centred, path):
    """One tap of a 3x3/s1 depthwise layer with a nonzero per-channel w_zp
    set so that its centred value is ``centred``: the strips take it while
    every centred tap fits int8; else op_dw with the int32 centred taps."""
    g = _graph("dw_edge_graph_wzp")
    layer = g.layers[1]
    in_shape = g.layers[0].out_shape
    zp = layer.w_q.zero_point
    zp[3] = -128 if centred > 0 else 127
    w = layer.weights.astype(np.int64)
    w[:, :, 3] = np.clip(w[:, :, 3], zp[3] - 128, zp[3] + 127)
    w[1, 2, 3] = centred + zp[3]
    assert w.min() >= -128 and w.max() <= 127
    layer.weights = w.astype(np.int8)
    seg = _one_layer_segment(layer, in_shape)
    buf, (row,) = _plan(seg)
    assert tmega.op_path(row) == path
    wc = w - zp[None, None, :]
    if path == "dw":
        taps = buf[row[tmega.F_W]:row[tmega.F_W] + 4 * wc.size].view(np.int32)
        assert np.array_equal(taps, wc.reshape(-1))
    else:
        assert np.array_equal(buf[row[tmega.F_D]:row[tmega.F_D] + 4 * wc.shape[2]].view(np.int32),
                              -layer.in_q.zp0 * wc.reshape(9, -1).sum(0))


@pytest.mark.parametrize("zero_point,path", [(0, "pw_mma"), (3, "pw"), (-1, "pw")])
def test_tensor_cores_need_zero_weight_zero_points(zero_point, path):
    """A 1x1 conv of person_detect (32 -> 64 channels): on the tensor cores
    while every w_zp is 0; one nonzero w_zp puts it on op_pw, whose F_WZP
    then holds the zero points and d = C*in_zp*w_zp - in_zp*colsum."""
    g = tparse(model_path("person_detect"))
    layer, in_shape = g.layers[8], g.layers[7].out_shape
    assert layer.filters.shape == (64, 1, 1, 32)
    zp = np.zeros(64, np.int64)
    zp[5] = zero_point
    layer.w_q.zero_point = zp
    buf, (row,) = _plan(_one_layer_segment(layer, in_shape))
    assert tmega.op_path(row) == path
    w = layer.filters.reshape(64, 32).astype(np.int64)
    in_zp = layer.in_q.zp0
    d = buf[row[tmega.F_D]:row[tmega.F_D] + 4 * 64].view(np.int32)
    assert np.array_equal(d, 32 * in_zp * zp - in_zp * w.sum(1))
    if path == "pw":
        assert np.array_equal(buf[row[tmega.F_WZP]:row[tmega.F_WZP] + 4 * 64].view(np.int32), zp)
