"""The packed kernel's device plan on the CPU (``kernels/packed.py``): the
flat kernel's ops of the packed prefix's layers (``device_ops``), packed by
``kernels/flatpack.py::pack_plan`` in ``exact`` mode, which the card runs on
the shared strip, tensor-core and general paths of ``csrc/packed.cu``.

* The identity the redesign rests on: the device plan's plain forward
  (``flat_forward_reference(ops, x, "exact")``) is bit-equal to the packed
  plain version (``packed_reference``: guard rows, per-lane planes with
  ``edge_d``, skipped horizontal taps), and to the JAX packed kernel in
  interpret mode.
* The plan bytes: the numpy emulators of ``op_dw3``, ``op_pw_mma`` and
  ``op_dw_vec`` (``tests/torch_emulators.py``) replay them and give exactly
  the JAX package's accumulators.
* The marks: ``PackedKernel.paths`` and every op's ``F_EXACT``.
* A mutant: the same plan with the ``exact2`` epilogue differs from
  ``packed_reference`` on ``chip_smoke.packed_edge_graph``, whose last
  layer puts y on +-(0.5 - 2**-25).
"""

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity as tp
from test_torch_packed import _jax_packed
from torch_emulators import op_dw3, op_dw_vec, op_pw_mma

from microflow_tpu.compiler.builder import init_params as j_init_params
from microflow_tpu.frontend import parse as jparse
from microflow_tpu.ops.conv_2d import conv_2d_accumulate
from microflow_tpu.ops.depthwise_conv_2d import depthwise_conv_2d_accumulate
from microflow_tpu_torch import build
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.kernels import build_packed_kernel, flat_forward_reference
from microflow_tpu_torch.kernels import flatpack as tflat
from microflow_tpu_torch.kernels import packed as tpacked
from microflow_tpu_torch.kernels.packed import packed_reference
from microflow_tpu_torch.models import model_path

PD = model_path("person_detect")
# person_detect's prefix, layers 0-22: the stem, then 1x1 convs and 3x3
# depthwise convs at these strides
PD_PATHS = (["dw3_stem", "dw3_s1"]
            + [p for s in (2, 1, 2, 1, 2, 1, 1, 1, 1, 1) for p in ("pw_mma", f"dw3_s{s}")]
            + ["pw_mma"])
EMULATORS = {"pw_mma": op_pw_mma, "dw3_s1": op_dw3, "dw3_s2": op_dw3, "dw3_stem": op_dw3,
             "dw_vec": op_dw_vec}


def _graph(name, seed=0):
    if name == "person_detect":
        return tparse(PD)
    if name == "packed_graph":
        return chip_smoke.packed_graph(np.random.default_rng(seed))
    return chip_smoke.packed_edge_graph(np.random.default_rng(seed))


def _kernel(name, max_layers=None, seed=0):
    return build_packed_kernel(_graph(name, seed), max_layers=max_layers, device="cpu")


def _plan_bytes(ops, requant="exact"):
    return tflat.pack_plan(ops, requant)[0]


@pytest.mark.parametrize("name,max_layers", [("person_detect", 5), ("person_detect", 9),
                                             ("person_detect", 15), ("person_detect", None),
                                             ("packed_graph", None)])
def test_device_ops_are_the_flat_planners(name, max_layers):
    """Where the flat planner takes the prefix, the device plan is its
    plan of the same layers, to the byte."""
    g = _graph(name)
    fn, n, _ = build_packed_kernel(g, max_layers=max_layers, device="cpu")
    flat_ops = tflat.plan_flat(g, max_layers=n)[0]
    assert [op.layer_idx for op in fn.flat_ops] == list(range(n))
    assert np.array_equal(_plan_bytes(fn.flat_ops), _plan_bytes(flat_ops))


CASES = ([("person_detect", n, 0) for n in (5, 9, 15, 23)]
         + [("packed_graph", None, s) for s in range(4)]
         + [("packed_edge_graph", None, s) for s in range(2)])


@pytest.mark.parametrize("name,max_layers,seed", CASES)
def test_device_plan_equals_packed_reference(name, max_layers, seed):
    """The identity: the flat form (every tap outside the input removed,
    rows and columns alike, one per-channel d) and the packed form (guard
    rows of the zero point, horizontal taps skipped, per-lane planes with
    edge_d) give the same bits, round half away from zero in both."""
    fn, n, meta = _kernel(name, max_layers, seed)
    assert max_layers is None or n == max_layers
    b = 2 if name == "person_detect" else 5
    xn = np.random.default_rng(seed + 7).integers(-128, 128, (b, *fn.in_shape), dtype=np.int8)
    xn.flat[:2] = (-128, 127)
    x = torch.from_numpy(xn)
    want = packed_reference(fn.ops, x)
    got = flat_forward_reference(fn.flat_ops, x.reshape(b, -1), "exact")
    assert torch.equal(got, want.reshape(b, -1))


def test_device_plan_equals_jax_packed_kernel():
    """The device plan's plain forward against the JAX packed kernel in
    interpret mode, person_detect layers 0-8, batch 2, at a seed where the
    FMA sets along the JAX chain are empty (``tests/torch_parity.py``)."""
    jg, tg = jparse(PD, frontend="python"), tparse(PD)
    x = np.random.default_rng(0).integers(-128, 128, (2, 96, 96, 1), dtype=np.int8)
    want, n = _jax_packed(jg, x, 9)
    counts = tp.chain_sets(jg, j_init_params(jg), x, n)
    counts.pop("outputs")
    assert not any(counts.values()), f"pick another seed, the sets are not empty: {counts}"
    fn, tn, _ = build_packed_kernel(tg, max_layers=9, device="cpu")
    got = flat_forward_reference(fn.flat_ops, torch.from_numpy(x).reshape(2, -1), "exact")
    assert tn == n and np.array_equal(got.numpy(), want.reshape(2, -1))


def _oracle(layer, x, in_shape):
    """The JAX package's exact int32 accumulators of a layer (every w_zp 0);
    the stem's one input channel goes to every output channel."""
    geom = tp.jax_graph(layer.geom)
    if hasattr(layer, "filters"):
        return conv_2d_accumulate(jnp.asarray(x), jnp.asarray(layer.filters), geom,
                                  layer.in_q.zp0, np.zeros(layer.filters.shape[0], np.int64))
    c = layer.weights.shape[2]
    if in_shape[2] != c:
        x = x[..., [0] * c]
    return depthwise_conv_2d_accumulate(jnp.asarray(x), jnp.asarray(layer.weights), geom,
                                        layer.in_q.zp0, np.zeros(c, np.int64))


def _shared_path_ops(name):
    """(op index, path) of every op of the graph's packed plan on a shared
    path."""
    fn, _, _ = _kernel(name)
    return [(i, p) for i, p in enumerate(fn.paths) if p in EMULATORS]


EMULATED = ([("person_detect", i) for i, _ in _shared_path_ops("person_detect")]
            + [("packed_edge_graph", i) for i, _ in _shared_path_ops("packed_edge_graph")])


@pytest.mark.parametrize("name,i", EMULATED)
def test_emulated_paths_replay_the_packed_plan(name, i):
    """Each op on a shared path, replayed by its emulator on the packed
    plan's descriptor and bytes, gives exactly the JAX accumulators:
    person_detect's 23 ops, and the edge graph's op_dw_vec (its 3x3
    depthwise conv at column stride 2), strips and tensor-core convs."""
    g = _graph(name)
    fn, _, _ = build_packed_kernel(g, device="cpu")
    buf, _ = tflat.pack_plan(fn.flat_ops, "exact")
    op = fn.flat_ops[i]
    rng = np.random.default_rng(i)
    x = rng.integers(-128, 128, (2, *op.in_shape), dtype=np.int8)
    x.flat[:2] = (-128, 127)
    want = np.asarray(_oracle(g.layers[i], x, op.in_shape))
    assert want.dtype == np.int32
    for b in range(2):
        got = EMULATORS[fn.paths[i]](fn.desc[i], buf, x[b].reshape(-1))
        assert np.array_equal(got, want[b].reshape(got.shape).astype(np.int64))


def test_the_emulated_ops_cover_every_shared_path():
    assert len([c for c in EMULATED if c[0] == "person_detect"]) == 23
    assert {p for name in ("person_detect", "packed_edge_graph")
            for _, p in _shared_path_ops(name)} == set(EMULATORS)


@pytest.mark.parametrize("name", ["person_detect", "packed_graph", "packed_edge_graph"])
def test_paths_and_epilogue_marks(name):
    """person_detect's prefix: its 12 depthwise ops on the strips, its 11 1x1
    convs on mma.sync; the edge graph reaches every general path; every op
    rounds half away from zero (F_EXACT = R_EXACT), as packed_reference."""
    fn, n, _ = _kernel(name)
    want = {"person_detect": PD_PATHS, "packed_edge_graph": chip_smoke.PACKED_EDGE_PATHS,
            "packed_graph": ["dw3_stem", "dw3_s1", "pw_mma", "dw3_s2", "pw_mma", "dw3_s1",
                             "pw_mma"]}[name]
    assert fn.paths == want and n == len(want)
    assert (fn.desc[:, tflat.F_EXACT] == tflat.EPILOGUES["exact"]).all()
    assert fn.smem_a + fn.smem_b <= tflat.SMEM_BYTES
    if name == "person_detect":
        assert (fn.smem_a, fn.smem_b) == (36864, 18432)


def test_exact2_mutant_differs_on_the_corners():
    """The same plan with the exact2 epilogue (F_EXACT = R_EXACT2, every other
    byte equal) rounds the edge graph's lanes at y = +-(0.5 - 2**-25) to
    +-1, where packed_reference rounds them to 0: the tests see the
    epilogue field."""
    fn, _, _ = _kernel("packed_edge_graph")
    exact, exact2 = _plan_bytes(fn.flat_ops), _plan_bytes(fn.flat_ops, "exact2")
    n = len(fn.flat_ops)
    desc2 = exact2[:n * tflat.NF * 4].view(np.int32).reshape(n, tflat.NF)
    assert (desc2[:, tflat.F_EXACT] == tflat.EPILOGUES["exact2"]).all()
    differ = np.nonzero(exact != exact2)[0] // 4
    assert set(differ.tolist()) == {o * tflat.NF + tflat.F_EXACT for o in range(n)}
    x = torch.from_numpy(np.random.default_rng(3).integers(-128, 128, (3, *fn.in_shape),
                                                           dtype=np.int8))
    want = packed_reference(fn.ops, x)
    mutant = flat_forward_reference(fn.flat_ops, x.reshape(3, -1), "exact2").reshape(want.shape)
    corner = np.float32(0.5) - np.float32(2.0**-25)
    c0 = fn.flat_ops[-1].bias0
    lanes = {int(np.nonzero((c0 == s * corner) & (fn.flat_ops[-1].weights[:, 0, 0, 0] == 0))[0][0]): s
             for s in (1, -1)}
    for lane, sign in lanes.items():
        assert (want[..., lane] == 0).all() and (mutant[..., lane] == sign).all()
    assert (mutant != want).sum() >= 2 * want[..., 0].numel()


def test_builder_packed_matches_xla_on_the_edge_graph():
    """``packed_edge_graph`` packs whole, and the packed backend (its plain
    version) equals the plain backend on it."""
    g = _graph("packed_edge_graph")
    assert tpacked.plan_packed(g)[1] == len(g.layers) == len(chip_smoke.PACKED_EDGE)
    mp, mx = (build(g, backend=b, device="cpu") for b in ("packed", "xla"))
    x = torch.from_numpy(np.random.default_rng(4).integers(-128, 128, (3, *g.input_shape),
                                                           dtype=np.int8))
    assert torch.equal(mp.predict_inner(x), mx.predict_inner(x))


def test_a_plan_past_shared_memory_raises(monkeypatch):
    """The port's rule: a prefix whose per-sample pair of tensors does not
    fit one block's shared memory raises at build."""
    monkeypatch.setattr(tpacked, "SMEM_BYTES", 36864 + 18432 - 16)
    with pytest.raises(ValueError, match="shared memory"):
        _kernel("person_detect")
