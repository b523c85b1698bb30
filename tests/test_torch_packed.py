"""The port's packed-pipeline backend on the CPU (``kernels/packed.py``: its
plan and its plain version) against the JAX package's
``kernels/packed.py``, whose kernel runs in Pallas interpret mode here.

The JAX ``packed`` backend itself cannot run on the CPU (its builder
never asks for interpret mode; ROADMAP.md queue C), so the JAX kernel is
called directly.  The rule is ``tests/torch_parity.py``'s: bit-equal at a
seed where the FMA set along the JAX XLA chain is empty (the interpret-mode
kernel contracts its epilogue like the jitted chain).
"""

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity as tp

from microflow_tpu.compiler.builder import init_params as j_init_params
from microflow_tpu.frontend import parse as jparse
from microflow_tpu.kernels import packed as jpacked
from microflow_tpu_torch import build, compile_tflite
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.kernels import build_packed_kernel
from microflow_tpu_torch.kernels import packed as tpacked
from microflow_tpu_torch.models import model_path

PD = model_path("person_detect")


@pytest.fixture(scope="module")
def pd_graphs():
    return jparse(PD, frontend="python"), tparse(PD)


@pytest.mark.parametrize("max_layers,n_layers", [(None, 23), (5, 5), (9, 9), (15, 15),
                                                 (23, 23)])
def test_plan_matches_jax(pd_graphs, max_layers, n_layers):
    """n_layers, meta and every op's kind, rows, lanes, stride, zero points,
    planes and clip bounds equal the JAX plan's."""
    jg, tg = pd_graphs
    jops, jn, jmeta = jpacked.plan_packed(jg, max_layers=max_layers)
    tops, tn, tmeta = tpacked.plan_packed(tg, max_layers=max_layers)
    assert tn == jn == n_layers and tmeta == jmeta and len(tops) == len(jops) == n_layers
    for i, (t, j) in enumerate(zip(tops, jops)):
        for key in ("kind", "h_in", "h_out", "lanes_in", "lanes_out", "stride", "pad_value",
                    "out_zp", "clip_lo", "clip_hi"):
            assert getattr(t, key) == getattr(j, key), (i, key)
        for key in ("d_plane", "bias_plane", "c1_plane"):
            a, b = getattr(t, key), getattr(j, key)
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, key)
        assert t.layer_idx == i


@pytest.mark.parametrize("name,max_layers", [("sine", None), ("speech", None),
                                             ("person_detect", 4)])
def test_plan_refuses(name, max_layers):
    """Not packable: no depthwise stem (sine), a 10x8 stem (speech), and
    person_detect cut after its stride-2 layer 3 (three layers left)."""
    path = model_path(name)
    assert jpacked.plan_packed(jparse(path, frontend="python"), max_layers=max_layers) is None
    assert tpacked.plan_packed(tparse(path), max_layers=max_layers) is None
    if max_layers is None:
        with pytest.raises(ValueError, match="not packable"):
            compile_tflite(path, backend="packed", device="cpu")


def _jax_packed(jg, x: np.ndarray, max_layers):
    """The JAX kernel in interpret mode on [B, H, W, 1], guard rows added
    and stripped as its builder does: [B, h_out, w_out, c_out]."""
    fn, n, meta = jpacked.build_packed_kernel(jg, tb=2, interpret=True, max_layers=max_layers)
    b, h, w = x.shape[:3]
    zp = np.int8(jg.layers[0].in_q.zp0)
    g = np.full((b, 1, w), zp, np.int8)
    x2 = np.concatenate([g, x.reshape(b, h, w), g], axis=1).reshape(b * (h + 2), w)
    y = np.asarray(fn(jnp.asarray(x2))).reshape(b, meta["h_out"] + 2, meta["lanes_out"])
    return y[:, 1:1 + meta["h_out"]].reshape(b, meta["h_out"], meta["w_out"], meta["c_out"]), n


def _check_against_jax(jg, tg, x, max_layers):
    want, n = _jax_packed(jg, x, max_layers)
    counts = tp.chain_sets(jg, j_init_params(jg), x, n)
    assert np.array_equal(counts.pop("outputs")[-1], want)  # the kernel is the chain's function
    assert not any(counts.values()), f"pick another seed, the sets are not empty: {counts}"
    packed_fn, tn, meta = build_packed_kernel(tg, max_layers=max_layers, device="cpu")
    assert tn == n
    got = packed_fn(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int8 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("max_layers", [None, 5])
def test_plain_matches_jax_packed_kernel(pd_graphs, max_layers):
    """The plain version against the JAX packed kernel, person_detect,
    batch 2 (the whole prefix, layers 0-22, and the shortest, 0-4)."""
    jg, tg = pd_graphs
    x = np.random.default_rng(0).integers(-128, 128, (2, 96, 96, 1), dtype=np.int8)
    _check_against_jax(jg, tg, x, max_layers)


def test_hand_made_graph_matches_jax_packed_kernel():
    """``chip_smoke.packed_graph``, built in both IRs from the same arrays:
    every activation, random zero points, a stride-2 depthwise conv in the
    middle; the whole graph packs."""
    tg = chip_smoke.packed_graph(np.random.default_rng(0))
    jg = tp.jax_graph(tg)
    assert tpacked.plan_packed(tg)[1] == len(tg.layers) == 7
    x = np.random.default_rng(1).integers(-128, 128, (2, *tg.input_shape), dtype=np.int8)
    _check_against_jax(jg, tg, x, None)


@pytest.mark.parametrize("name", ["person_detect", "packed_graph"])
def test_builder_packed_matches_xla(name):
    """The whole model through ``backend="packed"`` (the prefix's plain
    version, then the plain tail) equals the plain backend, batch 3."""
    if name == "person_detect":
        mp, mx = (compile_tflite(PD, backend=b, device="cpu") for b in ("packed", "xla"))
    else:
        tg = chip_smoke.packed_graph(np.random.default_rng(0))
        mp, mx = (build(tg, backend=b, device="cpu") for b in ("packed", "xla"))
    x = torch.from_numpy(np.random.default_rng(3).integers(
        -128, 128, (3, *mp.graph.input_shape), dtype=np.int8))
    assert torch.equal(mp.predict_inner(x), mx.predict_inner(x))
    assert mp.predict_inner(x[:0]).shape == (0, *mx.graph.output_shape)


def test_port_rules_refuse_what_the_jax_kernel_would_miscompute():
    """The port's own packing rules: a VALID-padded depthwise conv ends the
    prefix before it (the JAX plan takes it and computes SAME windows)."""
    from microflow_tpu_torch.core.tensor import ViewGeometry, ViewPadding

    tg = chip_smoke.packed_graph(np.random.default_rng(0))
    layer = tg.layers[5]  # 3x3 stride-1 depthwise conv at 4x8x32
    g = layer.geom
    layer.geom = ViewGeometry(g.in_rows, g.in_cols, 3, 3, g.out_rows, g.out_cols, 1, 1,
                              ViewPadding.VALID)
    assert tpacked.plan_packed(tg)[1] == 5
    assert jpacked.plan_packed(tp.jax_graph(tg))[1] == 7
