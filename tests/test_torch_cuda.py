"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a card.
This file imports neither JAX nor ``microflow_tpu``, so it runs on the
card's machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

(``python3 chip_smoke.py`` covers the same ground at every layer shape
of the three models.)  The case builders are shared with
``test_torch_kernels.py``.
"""

import chip_smoke
import numpy as np
import pytest
import torch

from microflow_tpu_torch import compile_tflite, parse
from microflow_tpu_torch.core import FusedActivation as TAct
from microflow_tpu_torch.kernels import (
    LAUNCHES,
    build_col_kernel,
    build_flat_kernel,
    build_fused_forward,
    build_packed_kernel,
    colfc_reference,
    flat_forward_reference,
    packed_reference,
    qdwconv,
    qdwconv_reference,
    qgemm,
    qgemm_reference,
)
from microflow_tpu_torch.kernels import megakernel as tmega
from microflow_tpu_torch.kernels.megakernel import hybrid_split_index
from microflow_tpu_torch.kernels.qgemm import qgemm_path
from microflow_tpu_torch.models import GOLDENS, model_path

F32 = np.float32


def gemm_case(rng, M, K, N, w_zp, in_zp):
    x = rng.integers(-128, 128, (M, K), dtype=np.int8)
    w = rng.integers(-128, 128, (K, N), dtype=np.int8)
    wzp = np.asarray(np.broadcast_to(w_zp, (N,)), np.int32)
    d = (K * in_zp * wzp - in_zp * w.astype(np.int64).sum(0)).astype(np.int32)
    bias0 = (F32(4) + rng.normal(0, 3, N)).astype(F32)
    c1 = rng.uniform(1e-4, 5e-3, N).astype(F32)
    return x, w, wzp, d, bias0, c1


def torch_args(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def dw_case(rng, B, H, W, C, kh, kw, sr, sc, in_zp, cin=None):
    """An unpadded int8 input of ``cin`` (default C) channels and the
    kernel's other arguments, SAME-padded as the reference pads (top/left
    ``(k - 1) // 2``)."""
    oh, ow = -(-H // sr), -(-W // sc)
    x = rng.integers(-128, 128, (B, H, W, C if cin is None else cin), dtype=np.int8)
    w = rng.integers(-128, 128, (kh, kw, C), dtype=np.int8)
    w_zp = rng.integers(-5, 6, C).astype(np.int32)
    wc = w.astype(np.int32) - w_zp[None, None, :]
    d = (-in_zp * wc.sum(axis=(0, 1))).astype(np.int32)
    bias0 = (F32(-1) + rng.normal(0, 3, C)).astype(F32)
    c1 = rng.uniform(0.001, 0.01, C).astype(F32)
    return x, wc, d, bias0, c1, dict(in_zp=in_zp, pad_top=(kh - 1) // 2, pad_left=(kw - 1) // 2,
                                     kh=kh, kw=kw, sr=sr, sc=sc, oh=oh, ow=ow)


def np_zp_padded(x, c, geo):
    """``x`` padded with ``in_zp`` so that every window of ``geo`` lies
    inside, the one channel of a stem input repeated to ``c``: the input
    the JAX kernel takes."""
    _, H, W, cin = x.shape
    top, left = geo["pad_top"], geo["pad_left"]
    bottom = max(0, geo["sr"] * (geo["oh"] - 1) + geo["kh"] - top - H)
    right = max(0, geo["sc"] * (geo["ow"] - 1) + geo["kw"] - left - W)
    xs = x if cin == c else np.repeat(x, c, axis=3)
    return np.pad(xs, ((0, 0), (top, bottom), (left, right), (0, 0)),
                  constant_values=geo["in_zp"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,path", [(5, 37, 11, "dp4a"), (1000, 1, 16, "dp4a"),
                                        (70000, 8, 16, "dp4a"), (3001, 16, 32, "dp4a"),
                                        (1001, 32, 64, "dp4a"), (77, 63, 130, "dp4a"),
                                        (513, 130, 129, "mma"), (64, 4000, 4, "mma"),
                                        (70000, 256, 256, "mma"), (3, 65, 2, "mma")])
def test_qgemm_kernel_matches_plain(cuda, M, K, N, path):
    assert qgemm_path(M, K, N) == path
    rng = np.random.default_rng(M + K + N)
    args = [a.to(cuda) for a in torch_args(*gemm_case(rng, M, K, N, rng.integers(-4, 4, N), 5))]
    for act in TAct:
        kw = dict(activation=act, out_scale=0.04, out_zp=-3)
        n = LAUNCHES["qgemm"]
        assert torch.equal(qgemm(*args, **kw), qgemm_reference(*args, **kw))
        assert LAUNCHES["qgemm"] == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,kh,kw,sr,sc", [(3, 9, 9, 5, 3, 3, 2, 2),
                                                (4, 49, 40, 8, 10, 8, 2, 2),
                                                (8, 12, 12, 64, 3, 3, 1, 1)])
def test_qdwconv_kernel_matches_plain(cuda, B, H, W, C, kh, kw, sr, sc):
    rng = np.random.default_rng(C)
    x, wc, d, bias0, c1, geo = dw_case(rng, B, H, W, C, kh, kw, sr, sc, in_zp=-3)
    args = [a.to(cuda) for a in torch_args(x, wc, d, bias0, c1)]
    for act in TAct:
        kwargs = dict(activation=act, out_scale=0.05, out_zp=2, **geo)
        n = LAUNCHES["qdwconv"]
        assert torch.equal(qdwconv(*args, **kwargs), qdwconv_reference(*args, **kwargs))
        assert LAUNCHES["qdwconv"] == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.DW_EDGE_CASES)
def test_qdwconv_edge_cases_match_plain(cuda, case):
    """The unpadded input at the edges of the 3x3 tile paths and on the
    general path (``chip_smoke.DW_EDGE_CASES``), every activation."""
    B, H, W, cin, C, kh, kw, sr, sc, pad, taps, zp, offset = case
    rng = np.random.default_rng(H * W + C)
    x, wc, d, bias0, c1, geo = dw_case(rng, B, H, W, C, kh, kw, sr, sc, in_zp=zp, cin=cin)
    if pad == "VALID":
        geo.update(pad_top=0, pad_left=0, oh=(H - kh) // sr + 1, ow=(W - kw) // sc + 1)
    if taps:  # the promise the tile paths need: centred weights that fit int8
        wc = wc.clip(-128, 127).astype(np.int32)
    d = (-zp * wc.sum(axis=(0, 1))).astype(np.int32)
    buf = torch.empty(x.size + offset, dtype=torch.int8, device=cuda)
    xd = buf[offset:].view(x.shape)  # the input at ``offset`` bytes past an aligned address
    xd.copy_(torch.from_numpy(x))
    args = [xd] + [a.to(cuda) for a in torch_args(wc, d, bias0, c1)]
    for act in TAct:
        kwargs = dict(activation=act, out_scale=0.05, out_zp=-4, int8_taps=taps, **geo)
        n = LAUNCHES["qdwconv"]
        assert torch.equal(qdwconv(*args, **kwargs), qdwconv_reference(*args, **kwargs))
        assert LAUNCHES["qdwconv"] == n + (B > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,max_layers,requant", [
    ("sine", None, "exact2"), ("speech", None, "exact2"), ("speech", None, "exact"),
    ("person_detect", None, "exact2"), ("person_detect", 2, "exact2"),
    ("person_detect", 12, "exact"), ("pw_edge_graph", None, "exact2"),
    ("pw_edge_graph", None, "exact"), ("dw_edge_graph", None, "exact2"),
    ("dw_edge_graph", None, "exact"), ("sine", None, "fixed"), ("speech", None, "fixed"),
    ("person_detect", None, "fixed"), ("person_detect", 12, "fixed"),
    ("conv_graph", None, "fixed"), ("pw_edge_graph", None, "fixed"),
    ("dw_edge_graph", None, "fixed"), ("fixed_edge_none", None, "fixed"),
    ("fixed_edge_relu", None, "fixed"), ("fixed_edge_relu6", None, "fixed")])
def test_flat_kernel_matches_plain(cuda, name, max_layers, requant):
    """The pw edge graph's 1x1 convs cover the edges of the tensor-core
    path (``chip_smoke.pw_edge_graph``), the dw edge graph's depthwise
    convs those of the 3x3 depthwise path (``chip_smoke.dw_edge_graph``),
    the fixed edge graphs those of the fixed-point epilogue
    (``chip_smoke.fixed_edge_graph``), which is its own instantiation of
    the kernel, counted as ``flatpack_fixed``."""
    g = _graph(name)
    flat_fn, n, meta = build_flat_kernel(g, max_layers=max_layers, requant=requant, device=cuda)
    rng = np.random.default_rng(n)
    for batch in (64, 3, 0):
        xn = rng.integers(-128, 128, (batch, meta["in_lanes"]), dtype=np.int8)
        xn.flat[:2] = (-128, 127)
        x = torch.from_numpy(xn)
        before = LAUNCHES[flat_fn.launch_key]
        got = flat_fn(x.to(cuda))
        assert LAUNCHES[flat_fn.launch_key] == before + (batch > 0)
        assert got.shape == (batch, meta["out_lanes"])
        assert torch.equal(got, flat_forward_reference(flat_fn.ops, x.to(cuda), requant))


@pytest.mark.cuda
@pytest.mark.parametrize("requant", ["raw", "noround"])
@pytest.mark.parametrize("name,max_layers", [
    ("speech", None), ("person_detect", None), ("person_detect", 12), ("conv_graph", None),
    ("pw_edge_graph", None), ("dw_edge_graph", None), ("noround_edge", None),
    ("raw_edge", None)])
def test_flat_measurement_modes_match_plain(cuda, name, max_layers, requant):
    """The measurement-only epilogues, each its own instantiation
    (``flat_kernel<R_RAW>``, ``<R_NOROUND>``, counted as ``flatpack_raw``
    and ``flatpack_noround``), bit-equal to the plain version on every op
    path, at their edges (``chip_smoke.noround_edge_graph``,
    ``raw_edge_graph``)."""
    test_flat_kernel_matches_plain(cuda, name, max_layers, requant)


@pytest.mark.cuda
def test_sharded_speech_step_on_the_card(cuda):
    """chip_smoke.py's phase 10, shorter: ``ShardedTrainer`` on speech
    through ``"pallas"`` on meshes that repeat the card, bit-equal to the
    replicated ``"pallas"`` and ``"xla"`` trainers, a ``qdwconv`` and a
    ``qsoftmax`` launch a cell a step."""
    res = chip_smoke.sharded_speech_checks(cuda, batch=64, steps=2)
    assert res["2x2"]["launches_per_step"] == {"qdwconv": 4, "qsoftmax": 4}
    assert res["1x2"]["launches_per_step"] == {"qdwconv": 2, "qsoftmax": 2}


@pytest.mark.cuda
def test_fixed_refusal_has_no_fallback(cuda, monkeypatch):
    """``MFT_FLAT_REQUANT=fixed`` on a graph whose ``d + bias_q`` leaves
    int32: ``"flat"`` and ``"auto"`` raise; nothing runs in its place."""
    from microflow_tpu_torch.compiler.builder import CompiledModel

    g = chip_smoke.fixed_edge_graph(TAct.NONE, 0, 0.05)
    layer = g.layers[1]
    layer.c0 = layer.c0.copy()
    layer.c0[0] = np.float32(2.0**31) * layer.c1[0]  # bias_q = 2**31 on lane 0
    monkeypatch.setenv("MFT_FLAT_REQUANT", "fixed")
    before = dict(LAUNCHES)
    for backend in ("flat", "auto"):
        with pytest.raises(ValueError, match="leaves int32"):
            CompiledModel(g, backend=backend, device=cuda)
    assert dict(LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["i32", "f32"])
def test_colfc_kernel_matches_plain(cuda, compute):
    col_fn, meta = build_col_kernel(parse(model_path("sine")), compute=compute, device=cuda)
    assert meta["compute"] == compute
    x = torch.from_numpy(np.random.default_rng(1).integers(-128, 128, (1000, 1), dtype=np.int8))
    before = LAUNCHES["colfc"]
    got = col_fn(x.to(cuda))
    assert LAUNCHES["colfc"] == before + 1
    assert torch.equal(got, colfc_reference(col_fn.plan, x.to(cuda)))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", chip_smoke.COL_CHAINS, ids=[c[0] for c in chip_smoke.COL_CHAINS])
def test_colfc_kernel_matches_plain_on_chains(cuda, spec):
    """The fabricated chains of ``chip_smoke.py``, x aligned and one byte off."""
    rng = np.random.default_rng(5)
    col_fn, meta = build_col_kernel(chip_smoke.col_chain_graph(rng, *spec), device=cuda)
    for b in (1, 15, 17, 1000):
        x = torch.from_numpy(rng.integers(-128, 128, (b, meta["k0"]), dtype=np.int8)).to(cuda)
        raw = torch.empty(x.numel() + 1, dtype=torch.int8, device=cuda)
        for xo in (x, raw[1:].view(x.shape).copy_(x)):
            assert torch.equal(col_fn(xo), colfc_reference(col_fn.plan, x)), b


def _graph(name):
    if name in ("noround_edge", "raw_edge"):
        return getattr(chip_smoke, f"{name}_graph")()
    if name == "conv_graph":
        return chip_smoke.conv_graph(np.random.default_rng(0))
    if name.startswith("fixed_edge_"):
        (spec,) = [s for s in chip_smoke.FIXED_EDGE_ACTS if f"fixed_edge_{s[0].value}" == name]
        return chip_smoke.fixed_edge_graph(*spec)
    if name == "conv_graph_wzp":
        return chip_smoke.conv_graph(np.random.default_rng(0), wzp=True)
    if name == "packed_graph":
        return chip_smoke.packed_graph(np.random.default_rng(0))
    if name == "packed_edge_graph":
        return chip_smoke.packed_edge_graph(np.random.default_rng(0))
    if name == "pw_edge_graph":
        return chip_smoke.pw_edge_graph(np.random.default_rng(0))
    if name == "dw_edge_graph":
        return chip_smoke.dw_edge_graph(np.random.default_rng(0))
    if name == "dw_edge_graph_wzp":
        return chip_smoke.dw_edge_graph(np.random.default_rng(0), wzp=True)
    return parse(model_path(name))


@pytest.mark.cuda
@pytest.mark.parametrize("name,backend", [
    ("person_detect", "fused"), ("person_detect", "hybrid"), ("speech", "fused"),
    ("sine", "fused"), ("conv_graph_wzp", "fused"), ("pw_edge_graph", "fused"),
    ("dw_edge_graph", "fused"), ("dw_edge_graph_wzp", "fused")])
def test_megakernel_matches_plain(cuda, name, backend):
    """Every segment, bit-equal to its plain version; the edge graphs put
    the megakernel's tensor-core 1x1 path and its 3x3 strips at their edges,
    ``dw_edge_graph_wzp`` with per-channel weight zero points
    (``chip_smoke.DW_EDGE_WZP_PATHS``)."""
    g = _graph(name)
    fwd = build_fused_forward(g, hybrid_split_index(g) if backend == "hybrid" else 0,
                              device=cuda)
    assert fwd.segments
    rng = np.random.default_rng(len(g.layers))
    for seg in fwd.segments:
        for batch in (64, 3, 0):
            x = torch.from_numpy(rng.integers(-128, 128, (batch, *seg.segment.in_shape),
                                              dtype=np.int8)).to(cuda)
            before = LAUNCHES["megakernel"]
            got = seg(x)
            assert LAUNCHES["megakernel"] == before + (batch > 0)
            assert torch.equal(got, seg.reference(x))


@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [("F_MMA", 1), ("F_DW3", 1), ("F_IN", 0)])
def test_megakernel_refuses_a_plan_its_reads_do_not_fit(cuda, field, value):
    """The entry point rechecks the plan's descriptors and refuses the
    launch: the tensor-core path marked on person_detect's 2-channel head,
    the 3x3 strips on that 1x1 conv, or an op whose input is not the tensor
    before it.  Nothing runs another path in its place."""
    from microflow_tpu_torch.kernels import megakernel as tmega

    (seg,) = build_fused_forward(parse(model_path("person_detect")), device=cuda).segments
    seg.desc[-1, getattr(tmega, field)] = value
    x = torch.zeros((2, *seg.segment.in_shape), dtype=torch.int8, device=cuda)
    before = LAUNCHES["megakernel"]
    with pytest.raises(RuntimeError, match="megakernel launch failed"):
        seg(x)
    assert LAUNCHES["megakernel"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("name,max_layers", [("person_detect", None), ("person_detect", 5),
                                             ("person_detect", 9), ("person_detect", 15),
                                             ("packed_graph", None),
                                             ("packed_edge_graph", None)])
def test_packed_kernel_matches_plain(cuda, name, max_layers):
    """Bit-equal to the plain version; ``packed_edge_graph`` takes every
    general path of the kernel and puts its last 1x1 conv's epilogue on the
    exact2 corners, +-k.5 and past both rails."""
    packed_fn, n, meta = build_packed_kernel(_graph(name), max_layers=max_layers, device=cuda)
    if name == "packed_edge_graph":
        assert packed_fn.paths == chip_smoke.PACKED_EDGE_PATHS
    rng = np.random.default_rng(n)
    for batch in (64, 3, 0):
        x = torch.from_numpy(rng.integers(-128, 128, (batch, meta["in_rows"], meta["in_cols"], 1),
                                          dtype=np.int8)).to(cuda)
        before = LAUNCHES["packed"]
        got = packed_fn(x)
        assert LAUNCHES["packed"] == before + (batch > 0)
        assert got.shape == (batch, meta["h_out"], meta["w_out"], meta["c_out"])
        assert torch.equal(got, packed_reference(packed_fn.ops, x))


@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [("F_EXACT", 0), ("F_DW3", 1), ("F_IN", 0)])
def test_packed_refuses_a_plan_its_reads_do_not_fit(cuda, field, value):
    """The entry point rechecks the plan's descriptors and refuses the
    launch: the last 1x1 conv of person_detect's prefix marked to round
    exact2, or on the 3x3 strips, or taking another tensor than the one
    before it.  Nothing runs another path in its place."""
    packed_fn, _, _ = build_packed_kernel(parse(model_path("person_detect")), device=cuda)
    packed_fn.desc[-1, getattr(tmega, field)] = value
    x = torch.zeros((2, *packed_fn.in_shape), dtype=torch.int8, device=cuda)
    before = LAUNCHES["packed"]
    with pytest.raises(RuntimeError, match="packed launch failed"):
        packed_fn(x)
    assert LAUNCHES["packed"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sine", "speech", "person_detect"])
def test_models_on_the_card(cuda, name, monkeypatch):
    """Goldens through the default backend (the flat kernel for the conv
    graphs, the per-op kernels for sine), and every kernel backend
    bit-equal to the plain backend on random inputs.  The default is
    ``MFT_BACKEND``, which ``tests/conftest.py`` sets to ``xla`` for the
    JAX package's tests: unset here, it is ``auto``."""
    monkeypatch.delenv("MFT_BACKEND", raising=False)
    x, want = GOLDENS[name]
    m = compile_tflite(model_path(name))
    assert m.backend == ("pallas" if name == "sine" else "flat")
    assert np.array_equal(m.predict(x).cpu().numpy(), want)
    plain = compile_tflite(model_path(name), backend="xla")
    rng = np.random.default_rng(5)
    xq = torch.from_numpy(rng.integers(-128, 128, (64, *m.graph.input_shape), dtype=np.int8))
    want_q = plain.predict_inner(xq.to(cuda))
    extra = {"sine": ("colfc",), "person_detect": ("packed",)}.get(name, ())
    for backend in ("flat", "pallas", "fused", "hybrid") + extra:
        k = compile_tflite(model_path(name), backend=backend)
        assert torch.equal(k.predict_inner(xq.to(cuda)), want_q), backend
        if backend in ("fused", "hybrid", "packed"):
            assert np.array_equal(k.predict(x).cpu().numpy(), want), backend


@pytest.mark.cuda
def test_training_pallas_matches_xla_on_the_card(cuda):
    """chip_smoke.py's train phase, shorter: person_detect, speech and sine
    (also in float mode) trained through ``"pallas"`` and ``"xla"`` from
    the same params stay bit-equal, every trained layer gets a gradient,
    and a person_detect step launches the per-op kernels of the forward
    through ``"pallas"`` only, and ``qwgrad`` for its 1x1 convs through
    both."""
    res = chip_smoke.train_checks(cuda, batch=256, steps=2)
    pd = res["person_detect/quantized"]["launches"]
    assert all(n == {**chip_smoke.PD_FORWARD, **chip_smoke.PD_BACKWARD} for n in pd["pallas"]), pd
    assert all(n == chip_smoke.PD_BACKWARD for n in pd["xla"]), pd


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sine", "speech", "person_detect"])
def test_export_round_trip_on_the_card(cuda, name, tmp_path, monkeypatch):
    """A model exported and reparsed runs the same backend (``auto``'s) and
    computes the same bits on the card (chip_smoke.py phase 8 at batch
    1024)."""
    monkeypatch.delenv("MFT_BACKEND", raising=False)
    m = compile_tflite(model_path(name), name=name)
    assert m.backend == ("pallas" if name == "sine" else "flat")
    path = str(tmp_path / f"{name}.tflite")
    m.export(path)
    m2 = compile_tflite(path, name=name)
    assert m2.backend == m.backend
    gen = torch.Generator().manual_seed(0)
    xq = torch.randint(-128, 128, (256, *m.graph.input_shape), generator=gen,
                       dtype=torch.int8).to(cuda)
    assert torch.equal(m.predict_inner(xq), m2.predict_inner(xq))


@pytest.mark.cuda
@pytest.mark.parametrize("name,per_batch", [("person_detect", {"flatpack": 1}),
                                            ("sine", {"qgemm": 3})])
def test_batch_server_on_the_card(cuda, name, per_batch, monkeypatch):
    """chip_smoke.py's serve phase, shorter: 4 clients of mixed requests
    (host f32, host int8, int8 on the card; one over ``max_batch`` for
    person_detect) through ``BatchServer`` on the default backend: every
    result bit-equal to ``predict_inner``, the golden through the server,
    the counters and the launches a dispatched batch."""
    monkeypatch.delenv("MFT_BACKEND", raising=False)
    big = chip_smoke.SERVE_BIG if name == "person_detect" else None
    res = chip_smoke.serve_model(name, np.random.default_rng(3), cuda, 4, 3, big, warm=(64,),
                                 per_batch=per_batch)
    assert res["served_vs_predict_inner_max_abs_err"] == 0
    assert res["stats"]["requests_failed"] == 0


def _add_layer(zps=(-7, 12, -3), scales=(0.031, 0.047, 0.052), act=TAct.RELU6):
    from microflow_tpu_torch.compiler import folding
    from microflow_tpu_torch.compiler.ir import AddLayer, QuantInfo

    q1, q2, qo = (QuantInfo(np.array([s], F32), np.array([z], np.int64))
                  for s, z in zip(scales, zps))
    return AddLayer(0, q1, q2, qo, **folding.preprocess_add(q1, q2, qo, act), activation=act,
                    out_shape=())


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(65536, 0), (1, 0), (4099, 0), (4099, 3),
                                      (1024 * 56 * 56 * 24, 0)])
def test_qadd_matches_plain(cuda, n, offset):
    """``qadd`` on the card, bit-equal to its plain version: every pair of
    int8 codes, tails past the 16-byte vectors, unaligned views (the
    scalar path), MobileNetV2's largest ADD at batch 1024, and every
    activation."""
    from microflow_tpu_torch.kernels.qadd import qadd, qadd_reference

    gen = torch.Generator().manual_seed(n)
    x1 = torch.randint(-128, 128, (n + offset,), generator=gen, dtype=torch.int8)
    x2 = torch.randint(-128, 128, (n + offset,), generator=gen, dtype=torch.int8)
    if n == 65536:  # every pair of codes
        codes = torch.arange(-128, 128, dtype=torch.int8)
        x1, x2 = codes.repeat_interleave(256), codes.repeat(256)
    for act in TAct:
        layer = _add_layer(act=act)
        a, b = x1[offset:].to(cuda), x2[offset:].to(cuda)
        launches = LAUNCHES["qadd"]
        got = qadd(a, b, layer)
        assert LAUNCHES["qadd"] == launches + 1
        want = qadd_reference(x1[offset:], x2[offset:], layer)
        assert torch.equal(got.cpu(), want), act


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,in_scale", [(1024, 1001, 0.0913), (3, 129, 0.5), (700, 4000, 1.7)])
def test_qsoftmax_matches_plain(cuda, M, N, in_scale):
    """``qsoftmax`` on the card, bit-equal to the plain op there (each row
    summed left to right), at MobileNetV2's 1001 classes and around it."""
    from microflow_tpu_torch.kernels.qsoftmax import qsoftmax, qsoftmax_reference

    gen = torch.Generator().manual_seed(N)
    x = torch.randint(-128, 128, (M, N), generator=gen, dtype=torch.int8)
    kw = dict(in_scale=in_scale, out_scale=1 / 256.0, out_zp=-128)
    launches = LAUNCHES["qsoftmax"]
    got = qsoftmax(x.to(cuda), **kw)
    assert LAUNCHES["qsoftmax"] == launches + 1
    assert torch.equal(got, qsoftmax_reference(x.to(cuda), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("path,batch", [("synth", 64),
                                        ("benchmark/configs/mobilenet_v2.tflite", 2)])
def test_residual_walk_on_the_card(cuda, path, batch, tmp_path, monkeypatch):
    """A residual graph through ``auto`` (``pallas``: the graph walk over
    ``qgemm``, ``qdwconv`` and ``qadd``; the synthetic graph's first two
    layers through the flat kernel), bit-equal to the plain ops on the CPU
    and to the benchmark's plain reference."""
    from benchmark.reference_residual.model import Reference
    from microflow_tpu_torch.models import synth

    monkeypatch.delenv("MFT_BACKEND", raising=False)
    if path == "synth":
        path = synth.write(str(tmp_path / "residual.tflite"), synth.residual())
    m = compile_tflite(path)
    xla = compile_tflite(path, backend="xla", device="cpu")
    assert m.backend == ("flat" if path.endswith("residual.tflite") else "pallas")
    gen = torch.Generator().manual_seed(batch)
    xq = torch.randint(-128, 128, (batch, *m.graph.input_shape), generator=gen, dtype=torch.int8)
    launches = LAUNCHES["qadd"]
    got = m.predict_inner(xq.to(cuda)).cpu()
    adds = sum(type(layer).__name__ == "AddLayer" for layer in m.graph.layers)
    assert LAUNCHES["qadd"] == launches + adds
    assert torch.equal(got, xla.predict_inner(xq))
    assert torch.equal(got, Reference(path, "cpu").forward(xq))
    pallas = compile_tflite(path, backend="pallas")
    assert torch.equal(pallas.predict_inner(xq.to(cuda)).cpu(), got)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,moved", [((1024, 1001), torch.int8, True),
                                               ((4096, 2), torch.int8, False),
                                               ((300, 700), torch.float32, True),
                                               ((1 << 20,), torch.int8, True),
                                               (((1 << 20) + 1,), torch.int8, False)])
def test_keepable_outputs_leave_the_small_pool(cuda, shape, dtype, moved):
    """An output of more than 512 KiB and at most 1 MiB comes back at the head
    of a block past 1 MiB, with the same values; any other is returned as it
    is."""
    from microflow_tpu_torch.compiler.builder import SMALL_POOL_MAX, keepable

    y = torch.randint(-128, 128, shape, device=cuda).to(dtype)
    out = keepable(y)
    assert torch.equal(out, y) and out.shape == y.shape and out.dtype == dtype
    assert (out.untyped_storage().nbytes() == SMALL_POOL_MAX + 512) is moved
    assert (out.data_ptr() != y.data_ptr()) is moved


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1024, 640])
def test_kept_outputs_through_keepable_take_fewer_segments(cuda, rows):
    """57 outputs of MobileNetV2's shape at batch 1024 and 640 (1,025,024
    and 640,640 bytes), each kept: without ``keepable`` the allocator takes
    a new 2 MiB segment every second or third output, with it a 20 MiB
    segment every 19 outputs (and one 2 MiB segment for the copies'
    sources)."""
    from microflow_tpu_torch.compiler.builder import keepable

    def segments(fn) -> int:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_stats()["num_device_alloc"]
        kept = [fn(torch.full((rows, 1001), i % 100, dtype=torch.int8, device=cuda))
                for i in range(57)]
        assert all(int(k[0, 0]) == i % 100 for i, k in enumerate(kept))
        return torch.cuda.memory_stats()["num_device_alloc"] - before

    plain, moved = segments(lambda y: y), segments(keepable)
    assert plain >= 57 // 3 and moved * 3 <= plain, (plain, moved)
