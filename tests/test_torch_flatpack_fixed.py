"""The flat kernel's fixed-point epilogue (``requant="fixed"``) in the port
(``microflow_tpu_torch/kernels/flatpack.py``: its plan, its plain version,
the plan bytes the CUDA kernel reads) against the JAX package's
``kernels/flatpack.py`` with ``requant="fixed"``.

The rule is ``tests/torch_parity.py``'s: bit-equal, except where the JAX
kernel, run by XLA on the CPU, may contract ``f32(q) * m + 0.5`` (or the
pool's ``c0 * mean + c1``) into one fused multiply-add.  A whole-chain
comparison at a fixed seed first counts those sets along the chain
(``fixed_chain_sets``) and asserts that they are empty; it then demands
bit-equality (a final softmax within one LSB: the JAX kernel sums its
entries in another order).
"""

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_emulators as emu
import torch_parity as tp

from microflow_tpu.compiler.builder import init_params as j_init_params
from microflow_tpu.frontend import parse as jparse
from microflow_tpu.kernels import flatpack as jflat
from microflow_tpu.models import synth
from microflow_tpu_torch.compiler.builder import CompiledModel, select_backend
from microflow_tpu_torch.compiler.ir import (
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    Graph,
    QuantInfo,
)
from microflow_tpu_torch.core.activation import FusedActivation
from microflow_tpu_torch.core.numerics import broadcast_per_channel
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.kernels import build_flat_kernel, flat_forward_reference
from microflow_tpu_torch.kernels import flatpack as tflat
from microflow_tpu_torch.models import model_path

BUNDLED = ("sine", "speech", "person_detect")
MAC = (FullyConnectedLayer, Conv2DLayer, DepthwiseConv2DLayer)


def _path(name, tmp_path):
    if name in BUNDLED:
        return model_path(name)
    return synth.write(str(tmp_path / f"{name}.tflite"), getattr(synth, name)())


@pytest.mark.parametrize("name,max_layers", [
    ("sine", None), ("speech", None), ("flat_conv", None), ("person_detect", 3)])
def test_plain_matches_jax_flat_kernel(name, max_layers, tmp_path):
    """The plain fixed version against the JAX flat kernel with
    ``requant="fixed"`` in Pallas interpret mode, batch 8."""
    path = _path(name, tmp_path)
    jg, tg = jparse(path, frontend="python"), tparse(path)
    x = np.random.default_rng(7).integers(-128, 128, (8, *jg.input_shape), dtype=np.int8)
    x2 = x.reshape(8, -1)
    jfn, n, jmeta = jflat.build_flat_kernel(jg, tb=8, interpret=True, max_layers=max_layers,
                                            requant="fixed")
    off = jmeta["out_off"]
    want = np.asarray(jfn(jnp.asarray(x2)))[:, off:off + jmeta["out_lanes"]]
    flat_fn, tn, meta = build_flat_kernel(tg, max_layers=max_layers, requant="fixed",
                                          device="cpu")
    assert tn == n and meta["out_lanes"] == jmeta["out_lanes"] and flat_fn.requant == "fixed"
    counts = tp.fixed_chain_sets(jg, j_init_params(jg), flat_fn.ops, x)
    outs = counts.pop("outputs")
    assert not any(counts.values()), f"{name}: pick another seed, the sets are not empty: {counts}"
    got = flat_fn(torch.from_numpy(x2)).numpy()
    assert np.array_equal(got, outs[-1])
    assert got.dtype == np.int8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    if type(tg.layers[n - 1]).__name__ == "SoftmaxLayer":
        assert diff.max() <= 1, name
    else:
        assert diff.max() == 0, name


def test_image_inputs_reach_4_lsb_in_both_packages():
    """On image-like person_detect inputs (uniform in [0, 1), quantized) the
    fixed mode's output reaches 4 LSB from ``xla``, past the 2 that the JAX
    package's gate allows on random int8 samples (``tests/test_flatpack.py``,
    which the port also meets: ``chip_smoke.py`` phase 4). The JAX flat
    kernel gives the same bits on the 8 samples that deviate most."""
    path = model_path("person_detect")
    mx = CompiledModel(tparse(path), backend="xla", device="cpu")
    xf = np.random.default_rng(0).uniform(0, 1, (64, 96, 96, 1)).astype(np.float32)
    x2 = mx.quantize_input(torch.from_numpy(xf)).reshape(64, -1)
    flat_fn, _, _ = build_flat_kernel(tparse(path), requant="fixed", device="cpu")
    got = flat_fn(x2).numpy().astype(np.int64)
    dev = np.abs(got - mx.predict_inner(x2.reshape(64, 96, 96, 1)).numpy()).max(1)
    assert dev.max() == 4
    pick = np.argsort(-dev, kind="stable")[:8]
    jfn, _, jmeta = jflat.build_flat_kernel(jparse(path, frontend="python"), tb=8,
                                            interpret=True, requant="fixed")
    off = jmeta["out_off"]
    want = np.asarray(jfn(jnp.asarray(x2.numpy()[pick])))[:, off:off + 2]
    assert np.array_equal(got[pick], want.astype(np.int64))


@pytest.mark.parametrize("name", ["sine", "speech", "person_detect", "flat_conv"])
def test_fixed_planes_match_jax(name, tmp_path):
    """Per output lane, ``m`` and ``d + bias_q`` of every conv, dw and fc op
    equal the JAX plan's ``m_plane`` and ``db_plane``."""
    path = _path(name, tmp_path)
    jg, tg = jparse(path, frontend="python"), tparse(path)
    jops = {op.layer_idx: op for op in jflat.plan_flat(jg)[0] if op.db_plane is not None}
    tops = [op for op in tflat.plan_flat(tg)[0] if op.kind in ("dw", "conv", "pw", "fc")]
    assert sorted(jops) == [op.layer_idx for op in tops]
    for op in tops:
        jop = jops[op.layer_idx]
        lanes = slice(jop.out_off, jop.out_off + jop.lanes_out)
        c = op.out_shape[-1]
        d = -np.int64(op.in_zp) * tflat._colsum(tg.layers[op.layer_idx], op.in_shape)
        db = d.reshape(-1) + np.tile(op.bias_q, op.lanes_out // c)
        assert np.array_equal(jop.db_plane[0, lanes].astype(np.int64), db), op.layer_idx
        m = np.tile(op.m, op.lanes_out // c)
        assert jop.m_plane[0, lanes].tobytes() == m.tobytes(), op.layer_idx


@pytest.mark.parametrize("name", ["person_detect", "speech", "fixed_edge_relu6"])
def test_plan_bytes_carry_the_fixed_constants(name):
    """Under ``"fixed"`` a conv, dw or fc op's descriptor names the fixed
    epilogue, its ``F_BIAS`` words hold ``bias_q`` as i32 and its ``F_C1``
    words ``m``; ``F_OUTZP`` is ``out_zp``; every other byte is the
    ``exact2`` plan's."""
    ops = tflat.plan_flat(_graph(name))[0]
    fixed, _ = tflat.pack_plan(ops, "fixed")
    exact2, _ = tflat.pack_plan(ops)
    assert fixed.size == exact2.size
    nf = tflat.NF
    desc = fixed[:len(ops) * nf * 4].view(np.int32).reshape(len(ops), nf)
    differ = np.zeros(fixed.size, bool)
    for i, (op, row) in enumerate(zip(ops, desc)):
        assert row[tflat.F_EXACT] == tflat.EPILOGUES["fixed"]
        at = (i * nf + tflat.F_EXACT) * 4
        differ[at:at + 4] = True
        if op.kind not in ("dw", "conv", "pw", "fc"):
            continue
        assert row[tflat.F_OUTZP] == op.out_zp
        c = op.out_shape[-1]
        at_b, at_c = row[tflat.F_BIAS], row[tflat.F_C1]
        assert np.array_equal(fixed[at_b:at_b + 4 * c].view(np.int32), op.bias_q.astype(np.int32))
        assert fixed[at_c:at_c + 4 * c].view(np.float32).tobytes() == op.m.tobytes()
        assert exact2[at_b:at_b + 4 * c].view(np.float32).tobytes() == op.bias0.tobytes()
        differ[at_b:at_b + 4 * c] = differ[at_c:at_c + 4 * c] = True
    assert np.array_equal(fixed[~differ], exact2[~differ])


def _graph(name):
    if name == "pw_edge_graph":
        return chip_smoke.pw_edge_graph(np.random.default_rng(0))
    if name == "dw_edge_graph":
        return chip_smoke.dw_edge_graph(np.random.default_rng(0))
    if name.startswith("fixed_edge_"):
        (spec,) = [s for s in chip_smoke.FIXED_EDGE_ACTS if f"fixed_edge_{s[0].value}" == name]
        return chip_smoke.fixed_edge_graph(*spec)
    return tparse(model_path(name))


EMULATED = ([("pw_edge_graph", i, "mma") for i in chip_smoke.PW_EDGE_MMA]
            + [(f"fixed_edge_{a.value}", 1, "mma") for a, _, _ in chip_smoke.FIXED_EDGE_ACTS]
            + [("person_detect", i, "mma") for i in (2, 26)]
            + [("dw_edge_graph", i, "dw3") for i in chip_smoke.DW_EDGE_DW3]
            + [("person_detect", i, "dw3") for i in (0, 1, 3)]
            + [("speech", 1, "vec")])


@pytest.mark.parametrize("name,layer,path", EMULATED)
def test_emulated_fixed_epilogue_equals_plain(name, layer, path):
    """``op_pw_mma``, ``op_dw3``/``op_dw3_stem`` and ``op_dw_vec`` replayed
    from the ``"fixed"`` plan bytes (``tests/torch_emulators.py``), with
    their fixed epilogue, exactly equal to the plain version of the op."""
    ops = tflat.plan_flat(_graph(name))[0]
    buf, _ = tflat.pack_plan(ops, "fixed")
    desc = buf[:len(ops) * tflat.NF * 4].view(np.int32).reshape(len(ops), tflat.NF)
    (op, row), = [(o, r) for o, r in zip(ops, desc) if o.layer_idx == layer]
    assert bool(row[tflat.F_MMA]) == (path == "mma")
    assert bool(row[tflat.F_DW3]) == (path == "dw3") and bool(row[tflat.F_VEC]) == (path == "vec")
    rng = np.random.default_rng(layer)
    if name.startswith("fixed_edge_"):  # sweep the lanes' x over int8
        x = rng.integers(-128, 128, (256, op.lanes_in), dtype=np.int8)
        x[:, 0] = np.arange(-128, 128)
    else:
        x = rng.integers(-128, 128, (2, op.lanes_in), dtype=np.int8)
        x.flat[:2] = (-128, 127)
    run = {"mma": emu.op_pw_mma, "dw3": emu.op_dw3, "vec": emu.op_dw_vec}[path]
    want = flat_forward_reference([op], torch.from_numpy(x), "fixed").numpy()
    for b in range(x.shape[0]):
        got = emu.fixed_epilogue(row, buf, run(row, buf, x[b]))
        assert np.array_equal(got.reshape(-1), want[b].astype(np.int64)), b


def test_fixed_edge_graph_meets_its_edges():
    """The edge graph of ``chip_smoke.py`` puts p on +-(k + 0.5) and the
    ulps around it, past both rails and q past +-2**24."""
    sweep = np.arange(-128, 128).astype(np.int8)
    for spec in chip_smoke.FIXED_EDGE_ACTS:
        op = tflat.plan_flat(chip_smoke.fixed_edge_graph(*spec))[0][1]
        assert op.out_zp == spec[1] and op.kind == "pw" and tflat.pw_mma(op.in_shape,
                                                                         op.out_shape)
        counts = chip_smoke.fixed_edge_counts(op, sweep)
        assert all(counts.values()), counts


# --- the guard: |d + bias_q| < 2**31 on every lane ----------------------------


def guard_graph(bias_q: float, in_zp: int) -> Graph:
    """int8 [1] -> FC 1->1 (y = x) -> FC 1->4 with weights (100, -100, 50, 0),
    input zero point ``in_zp``, c1 = 1 and c0 = ``bias_q``: lane n's
    ``d + bias_q`` is ``-in_zp * w[n] + bias_q``."""
    q = lambda zp: QuantInfo(np.array([1.0], np.float32), np.array([zp], np.int64))
    w = np.array([[100, -100, 50, 0]], np.int8)
    first = chip_smoke._fc(0, np.ones((1, 1)), [0.0], 1.0, FusedActivation.NONE, 1.0)
    first.out_q = q(in_zp)
    second = FullyConnectedLayer(
        1, w, q(in_zp), q(0), q(0), q(0), np.full(4, bias_q, np.float32), np.float32(1.0),
        (in_zp * w.astype(np.int64).sum(0)).astype(np.int32), 0, FusedActivation.NONE, False,
        (4,))
    return Graph(name="guard", layers=[first, second], input_shape=(1,), input_q=q(0),
                 input_dtype=np.dtype(np.int8), output_shape=(4,), output_q=q(0),
                 output_dtype=np.dtype(np.int8))


@pytest.mark.parametrize("bias_q,in_zp,refused", [
    (2**31 - 1024, 0, False), (2**31 - 1024, -20, True), (2**31 - 1024, 20, True),
    (-(2**31) + 1024, 20, True), (-(2**31) + 1024, -20, True), (-(2**31) + 4096, 20, False),
    (2**31 - 4096, -20, False),
    (2**31, 0, True), (float("inf"), 0, True)])
def test_both_packages_refuse_the_same_graphs(bias_q, in_zp, refused):
    tg = guard_graph(bias_q, in_zp)
    jg = tp.jax_graph(tg)
    assert jflat.plan_flat(jg) is not None and tflat.plan_flat(tg) is not None
    jres = jflat.build_flat_kernel(jg, tb=8, interpret=True, requant="fixed")
    assert (jres is None) == refused
    assert build_flat_kernel(tg, device="cpu") is not None  # exact2 still builds
    if refused:
        with pytest.raises(ValueError, match="leaves int32"):
            build_flat_kernel(tg, requant="fixed", device="cpu")
        # refused before any device is touched: no fallback on the card either
        with pytest.raises(ValueError, match="leaves int32"):
            tflat.kernel_from_plan(tflat.plan_flat(tg), "fixed", device="cuda")
        return
    flat_fn, _, _ = build_flat_kernel(tg, requant="fixed", device="cpu")
    x = np.arange(-128, 128, dtype=np.int8).reshape(-1, 1)
    jfn, _, jmeta = jres
    want = np.asarray(jfn(jnp.asarray(x)))[:, jmeta["out_off"]:jmeta["out_off"] + 4]
    assert np.array_equal(flat_fn(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("name", BUNDLED)
def test_accumulators_of_the_bundled_models_stay_in_i32(name):
    """For every conv, dw and fc layer, max(|-128 - in_zp|, |127 - in_zp|) *
    sum |w| + |bias_q| < 2**31 on every channel, so ``acc + bias_q`` never
    wraps; only speech's FC (layer 2) can pass 2**24, where ``f32(q)``
    rounds (both packages round it alike: the chains above agree bit for
    bit)."""
    g = tparse(model_path(name))
    bounds = {}
    for layer in g.layers:
        if not isinstance(layer, MAC):
            continue
        if isinstance(layer, FullyConnectedLayer):
            sw = np.abs(layer.weights.astype(np.int64)).sum(0)
        elif isinstance(layer, Conv2DLayer):
            sw = np.abs(layer.filters.astype(np.int64)).reshape(len(layer.filters), -1).sum(1)
        else:
            sw = np.abs(layer.weights.astype(np.int64)).reshape(-1, layer.weights.shape[2]).sum(0)
        c1 = broadcast_per_channel(layer.c1, len(sw), np.float32)
        bias_q = np.abs(tflat.fixed_bias(layer.c0, c1, np.zeros(len(sw), np.int64)))
        zp = layer.in_q.zp0
        bounds[layer.index] = int((max(abs(-128 - zp), abs(127 - zp)) * sw + bias_q).max())
    assert max(bounds.values()) < 2**31
    want = {"sine": (182_886, []), "speech": (20_331_754, [2]),
            "person_detect": (3_424_134, [])}[name]
    assert (max(bounds.values()), [i for i, b in bounds.items() if b >= 2**24]) == want


# --- the builder's door: MFT_FLAT_REQUANT --------------------------------------


def test_builder_reads_mft_flat_requant(monkeypatch):
    g = tparse(model_path("person_detect"))
    x = torch.from_numpy(np.random.default_rng(3).integers(-128, 128, (2, 96, 96, 1),
                                                           dtype=np.int8))
    monkeypatch.setenv("MFT_FLAT_REQUANT", "fixed")
    m = CompiledModel(g, backend="flat", device="cpu")
    flat_fn, _, _ = build_flat_kernel(g, requant="fixed", device="cpu")
    assert torch.equal(m.predict_inner(x), flat_fn(x.reshape(2, -1)))
    # on the CPU "auto" is the plain xla backend; the variable does not apply
    assert CompiledModel(g, backend="auto", device="cpu").backend == "xla"
    monkeypatch.setenv("MFT_FLAT_REQUANT", "exact2")
    plain = CompiledModel(g, backend="xla", device="cpu").predict_inner(x)
    assert torch.equal(CompiledModel(g, backend="flat", device="cpu").predict_inner(x), plain)
    monkeypatch.setenv("MFT_FLAT_REQUANT", "noround")
    m = CompiledModel(g, backend="flat", device="cpu")
    flat_fn, _, _ = build_flat_kernel(g, requant="noround", device="cpu")
    assert m._flat[0].requant == "noround"
    assert torch.equal(m._flat[0](x.reshape(2, -1)), flat_fn(x.reshape(2, -1)))
    monkeypatch.setenv("MFT_FLAT_REQUANT", "fixed")
    with pytest.raises(ValueError, match="leaves int32"):
        CompiledModel(guard_graph(2**31 - 1024, 20), backend="flat", device="cpu")


def test_auto_refuses_fixed_on_the_card_before_it_runs():
    """A conv graph that ``"auto"`` puts on the flat kernel on CUDA, with
    ``bias_q = 2**31`` on one lane: under ``"fixed"`` the kernel is refused
    before any device is touched (the JAX package's ``"auto"`` falls back to
    XLA there; the port raises)."""
    g = chip_smoke.fixed_edge_graph(FusedActivation.NONE, 0, 0.05)
    layer = g.layers[1]
    layer.c0 = layer.c0.copy()
    layer.c0[0] = np.float32(2.0**31) * layer.c1[0]
    backend, plan = select_backend(g, "auto", "cuda")
    assert backend == "flat"
    with pytest.raises(ValueError, match="layer 1's d \\+ bias_q leaves int32"):
        tflat.kernel_from_plan(plan, "fixed", device="cuda")
    assert jflat.build_flat_kernel(tp.jax_graph(g), tb=8, interpret=True,
                                   requant="fixed") is None
