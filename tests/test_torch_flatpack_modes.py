"""The flat kernel's measurement-only epilogues ``requant="raw"`` and
``"noround"`` in the port (``microflow_tpu_torch/kernels/flatpack.py``: the
plain version, the plan bytes the CUDA kernel reads, the builder's
``MFT_FLAT_REQUANT``) against the JAX package's ``build_flat_kernel(...,
requant=mode)`` run in Pallas interpret mode at batch 8.

``raw`` is integer all the way (each op stores its accumulator's low byte,
and the next op reads it), so the two agree bit for bit.  ``noround``
computes ``y = bias0 + c1*f32(q)``, which XLA on the CPU contracts into one
fused multiply-add: the JAX output is held bit-equal to the port's chain
run with that contraction emulated (``torch_parity.noround_chain``), and
the port's own output to the JAX one wherever that chain's FMA set is
empty; the set is counted and listed.  A final softmax may differ by one
LSB (the JAX kernel sums its entries in another order).
"""

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity as tp

from microflow_tpu.compiler.builder import init_params as j_init_params
from microflow_tpu.frontend import parse as jparse
from microflow_tpu.kernels import flatpack as jflat
from microflow_tpu.models import synth
from microflow_tpu_torch.compiler.builder import CompiledModel
from microflow_tpu_torch.compiler.ir import SoftmaxLayer
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.kernels import build_flat_kernel, flat_forward_reference
from microflow_tpu_torch.kernels import flatpack as tflat
from microflow_tpu_torch.models import model_path

BUNDLED = ("sine", "speech", "person_detect")
EDGE = {"noround_edge": chip_smoke.noround_edge_graph, "raw_edge": chip_smoke.raw_edge_graph}
# (graph, max_layers): the bundled models, person_detect's first three
# layers, the flat-packable synthetic graph and the two edge graphs
GRAPHS = [("sine", None), ("speech", None), ("person_detect", 3), ("flat_conv", None),
          ("noround_edge", None), ("raw_edge", None)]
# noround's FMA set along each graph's chain at the inputs below (seed 7,
# batch 8; the edge graphs sweep int8), (layer, flat indices): none but on
# person_detect
NOROUND_FMA = {"person_detect": [(0, [101841]), (2, [179997])]}


def graphs(name, tmp_path):
    """(JAX graph, port graph) of a bundled, synthetic or edge graph."""
    if name in EDGE:
        g = EDGE[name]()
        return tp.jax_graph(g), g
    path = model_path(name) if name in BUNDLED else synth.write(
        str(tmp_path / f"{name}.tflite"), getattr(synth, name)())
    return jparse(path, frontend="python"), tparse(path)


def inputs(name, jg) -> np.ndarray:
    if name in EDGE:  # every int8 value, 8 rows at a time
        return np.arange(-128, 128, dtype=np.int8).reshape(256, 1)
    return np.random.default_rng(7).integers(-128, 128, (8, *jg.input_shape), dtype=np.int8)


def jax_kernel(jg, mode, max_layers, x):
    """The JAX flat kernel's output on ``x`` (batch a multiple of 8)."""
    jfn, n, jmeta = jflat.build_flat_kernel(jg, tb=8, interpret=True, max_layers=max_layers,
                                            requant=mode)
    off = jmeta["out_off"]
    b = x.shape[0]
    out = np.asarray(jfn(jnp.asarray(x.reshape(b, -1))))[:, off:off + jmeta["out_lanes"]]
    return out, n


def assert_equal(got, want, softmax_last: bool, what: str) -> None:
    assert got.dtype == np.int8 and got.shape == want.shape, (what, got.shape, want.shape)
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max(initial=0) <= (1 if softmax_last else 0), (what, diff.max(), diff.sum())


@pytest.mark.parametrize("name,max_layers", GRAPHS)
def test_raw_matches_jax_flat_kernel(name, max_layers, tmp_path):
    """``raw`` bit for bit: every op's accumulator as the JAX plan defines
    it (``q`` less ``d = -in_zp * colsum``), wrapped to its low byte."""
    jg, tg = graphs(name, tmp_path)
    x = inputs(name, jg)
    want, n = jax_kernel(jg, "raw", max_layers, x)
    fn, tn, meta = build_flat_kernel(tg, max_layers=max_layers, requant="raw", device="cpu")
    assert tn == n and fn.launch_key == "flatpack_raw"
    got = fn(torch.from_numpy(x.reshape(x.shape[0], -1))).numpy()
    assert_equal(got, want, isinstance(tg.layers[n - 1], SoftmaxLayer), name)


@pytest.mark.parametrize("name,max_layers", GRAPHS)
def test_noround_matches_jax_flat_kernel(name, max_layers, tmp_path):
    """``noround``: the JAX kernel equals the port's chain with the FMA
    contraction emulated; the port equals the JAX kernel but for the listed
    FMA set (none on most graphs, then bit for bit)."""
    jg, tg = graphs(name, tmp_path)
    x = inputs(name, jg)
    want, n = jax_kernel(jg, "noround", max_layers, x)
    fn, tn, _ = build_flat_kernel(tg, max_layers=max_layers, requant="noround", device="cpu")
    assert tn == n and fn.launch_key == "flatpack_noround"
    got = fn(torch.from_numpy(x.reshape(x.shape[0], -1))).numpy()
    softmax_last = isinstance(tg.layers[n - 1], SoftmaxLayer)
    jparams = j_init_params(jg)
    contracted, hits = tp.noround_chain(jg, jparams, fn.ops, x, contract=True)
    separate, hits_sep = tp.noround_chain(jg, jparams, fn.ops, x, contract=False)
    assert hits == NOROUND_FMA.get(name, []) and (hits_sep[:1] == hits[:1]), (name, hits)
    assert np.array_equal(separate, got), name
    assert_equal(contracted, want, softmax_last, f"{name} (FMA emulated)")
    if not hits:
        assert_equal(got, want, softmax_last, name)
    else:
        assert not np.array_equal(got, want), f"{name}: the FMA set changed nothing"


def test_edge_graphs_meet_their_edges():
    """The edge graphs chip_smoke.py runs on the card reach what they are
    for, on the int8 sweep: ``raw_edge`` accumulators outside int8,
    ``noround_edge`` y past both rails and outside its RELU6 bounds."""
    sweep = np.arange(-128, 128, dtype=np.int8)
    raw = chip_smoke.mode_edge_counts(chip_smoke.raw_edge_graph(), sweep)
    assert raw["acc_outside_int8"] > 500, raw
    nr = chip_smoke.mode_edge_counts(chip_smoke.noround_edge_graph(), sweep)
    assert nr["y_past_rails"] > 100 and nr["y_outside_activation_bounds"] > 100, nr
    fn, _, _ = build_flat_kernel(chip_smoke.noround_edge_graph(), requant="noround", device="cpu")
    y = fn(torch.from_numpy(sweep.reshape(-1, 1))).numpy()
    assert y.min() == -128 and y.max() == 127 and (y < 0).any()  # no clip to [0, 60]


@pytest.mark.parametrize("mode", ["raw", "noround"])
def test_plan_bytes_name_the_mode(mode):
    """The plan's descriptors: ``F_EXACT`` names the mode (the kernel's
    instantiation); under ``raw`` every op's ``F_ZP`` and ``d`` words are 0,
    elsewhere those of ``exact2``."""
    g = tparse(model_path("person_detect"))
    ops = tflat.plan_flat(g)[0]
    buf, split = tflat.pack_plan(ops, mode)
    base, _ = tflat.pack_plan(ops, "exact2")
    assert split == tflat.pack_plan(ops, "exact2")[1] and len(buf) == len(base)
    n = len(ops) * tflat.NF
    desc = buf[:n * 4].view(np.int32).reshape(len(ops), tflat.NF)
    desc0 = base[:n * 4].view(np.int32).reshape(len(ops), tflat.NF)
    assert (desc[:, tflat.F_EXACT] == tflat.EPILOGUES[mode]).all()
    other = [f for f in range(tflat.NF) if f not in (tflat.F_EXACT, tflat.F_ZP)]
    assert np.array_equal(desc[:, other], desc0[:, other])
    if mode == "noround":
        assert np.array_equal(buf[n * 4:], base[n * 4:])
        assert np.array_equal(desc[:, tflat.F_ZP], desc0[:, tflat.F_ZP])
        return
    assert not desc[:, tflat.F_ZP].any() and desc0[:, tflat.F_ZP].any()
    for op, f in zip(ops, desc):
        if f[tflat.F_D]:
            c = op.out_shape[-1]
            assert not buf[f[tflat.F_D]:f[tflat.F_D] + 4 * c].any(), op.layer_idx
    assert tflat.INSTANTIATIONS[mode] == {"raw": "R_RAW", "noround": "R_NOROUND"}[mode]


@pytest.mark.parametrize("mode", ["raw", "noround"])
@pytest.mark.parametrize("name", ["person_detect", "speech"])
def test_builder_reads_mft_flat_requant(monkeypatch, mode, name):
    """``MFT_FLAT_REQUANT=raw|noround`` builds the mode through
    ``backend="flat"``, as in the JAX package (``compiler/builder.py:387``):
    the model's forward is the mode's flat prefix, then the tail."""
    g = tparse(model_path(name))
    x = torch.from_numpy(np.random.default_rng(3).integers(-128, 128, (2, *g.input_shape),
                                                           dtype=np.int8))
    monkeypatch.setenv("MFT_FLAT_REQUANT", mode)
    m = CompiledModel(g, backend="flat", device="cpu")
    fn, n_layers, meta = build_flat_kernel(g, requant=mode, device="cpu")
    assert m._flat[0].requant == mode and m._flat[1] == n_layers
    y = flat_forward_reference(fn.ops, x.reshape(2, -1), mode).reshape(2, *meta["out_shape"])
    assert torch.equal(m.predict_inner(x), m._tail(y, n_layers))
    exact = CompiledModel(g, backend="xla", device="cpu").predict_inner(x)
    assert not torch.equal(m.predict_inner(x), exact) or mode == "noround"
