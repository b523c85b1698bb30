"""The port's megakernel backends on the CPU (``kernels/megakernel.py``:
the segmentation and the plain version) against the JAX package's
``fused`` and ``hybrid`` backends, whose Pallas kernel runs in interpret
mode here.

The rule is ``tests/torch_parity.py``'s: at a seed where the FMA and
``exact2``-corner sets along the JAX XLA chain are empty, bit-equal, a
final softmax within one LSB.  Every requant of these backends rounds half
away from zero, as the JAX package's XLA ops do.
"""

import chip_smoke
import numpy as np
import pytest
import torch
import torch_parity as tp

from microflow_tpu.compiler import builder as jbuilder
from microflow_tpu.frontend import parse as jparse
from microflow_tpu.kernels import megakernel as jmega
from microflow_tpu.models import synth
from microflow_tpu_torch import build, compile_tflite
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.kernels import build_fused_forward
from microflow_tpu_torch.kernels import megakernel as tmega
from microflow_tpu_torch.models import model_path

BUNDLED = ("sine", "speech", "person_detect")
SYNTH = ("lenet", "full_ops", "flat_conv", "per_channel_dw", "uint8_mlp")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    out = {name: model_path(name) for name in BUNDLED}
    for name in SYNTH:
        out[name] = synth.write(str(d / f"{name}.tflite"), getattr(synth, name)())
    return out


@pytest.mark.parametrize("name,fusable,split", [
    ("person_detect", True, 9), ("speech", True, 0), ("sine", True, 3), ("lenet", True, 5),
    ("full_ops", True, 7), ("flat_conv", True, 5), ("per_channel_dw", True, 2),
    ("uint8_mlp", False, 3)])
def test_fusable_and_split_match_jax(paths, name, fusable, split):
    jg, tg = jparse(paths[name], frontend="python"), tparse(paths[name])
    assert tmega.fusable(tg) == jmega.fusable(jg) == fusable
    assert tmega.hybrid_split_index(tg) == jmega.hybrid_split_index(jg) == split


def _steps(graph, start):
    steps, tail = tmega.plan_segments(graph, start)
    return [(kind, val.indices, val.in_shape, val.out_shape, val.gather)
            if kind == "segment" else (kind, val) for kind, val in steps], tail is not None


@pytest.mark.parametrize("name,start,want", [
    ("person_detect", 0, [("segment", list(range(29)), (96, 96, 1), (1, 1, 2), [0] * 8),
                          ("reshape", (2,))]),
    ("person_detect", 9, [("segment", list(range(9, 29)), (12, 12, 64), (1, 1, 2), None),
                          ("reshape", (2,))]),
    ("speech", 0, [("reshape", (49, 40, 1)), ("segment", [1], (49, 40, 1), (25, 20, 8), [0] * 8),
                   ("reshape", (4000,)), ("segment", [2], (4000,), (4,), None)]),
    ("sine", 0, [("segment", [0, 1, 2], (1,), (1,), None)]),
    ("sine", 3, []),
])
def test_segments(name, start, want):
    """The JAX package's segmentation: layer indices, the reshapes between
    segments and the entry gather of a depth-multiplier stem."""
    steps, tail = _steps(tparse(model_path(name)), start)
    assert steps == want
    assert tail == (name != "sine")


def _assert_rule(got: np.ndarray, want: np.ndarray, softmax: bool, what: str) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.shape, want.shape)
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max(initial=0) <= (1 if softmax else 0), (what, diff.max())


def _no_sets(jg, x, what) -> np.ndarray:
    """Assert the sets along the JAX XLA chain are empty; return its output."""
    counts = tp.chain_sets(jg, jbuilder.init_params(jg), x)
    out = counts.pop("outputs")[-1]
    assert not any(counts.values()), f"{what}: pick another seed, the sets are not empty: {counts}"
    return out


@pytest.mark.parametrize("name,batch,seed", [
    ("person_detect", 2, 0), ("speech", 8, 0), ("sine", 8, 0), ("lenet", 8, 0),
    ("full_ops", 8, 0), ("flat_conv", 8, 0), ("per_channel_dw", 8, 0)])
def test_fused_and_hybrid_match_jax(paths, name, batch, seed):
    """The port's ``fused`` and ``hybrid`` on the CPU (the kernel's plain
    version, and the plain ops for hybrid's prefix) against the JAX
    package's, run in interpret mode."""
    jg = jparse(paths[name], frontend="python")
    x = np.random.default_rng(seed).integers(-128, 128, (batch, *jg.input_shape), dtype=np.int8)
    _no_sets(jg, x, name)
    softmax = type(jg.layers[-1]).__name__ == "SoftmaxLayer"
    for backend in ("fused", "hybrid"):
        want = np.asarray(jbuilder.build(jg, backend=backend).predict_inner(x))
        got = compile_tflite(paths[name], backend=backend, device="cpu").predict_inner(x).numpy()
        _assert_rule(got, want, softmax, f"{name} {backend}")


def test_weight_zero_points_match_jax():
    """A hand-made graph (``chip_smoke.conv_graph(wzp=True)``) built in both
    IRs from the same arrays: a leading Quantize, nonzero per-channel
    weight zero points on a 3x3/s2 conv, a depthwise conv and a 1x1 conv,
    and a nonzero one on the FC.  The JAX megakernel cannot trace a conv
    with nonzero zero points (its kernel captures the zero-point array as a
    constant, which ``pallas_call`` refuses; ROADMAP.md queue C), so the
    port's ``fused`` is held against the JAX XLA chain on that graph, and
    against the JAX ``fused`` on the same graph with the conv zero points
    set to 0."""
    tg = chip_smoke.conv_graph(np.random.default_rng(0), wzp=True)
    x = np.random.default_rng(1).integers(-128, 128, (8, *tg.input_shape), dtype=np.int8)
    assert tmega.fusable(tg)
    assert any(np.any(layer.w_q.zero_point != 0) for layer in tg.layers
               if type(layer).__name__ == "Conv2DLayer")
    want = _no_sets(tp.jax_graph(tg), x, "conv_graph_wzp")
    got = build(tg, backend="fused", device="cpu").predict_inner(x).numpy()
    _assert_rule(got, want, True, "conv_graph_wzp vs the JAX XLA chain")
    for layer in tg.layers:
        if type(layer).__name__ == "Conv2DLayer":
            layer.w_q.zero_point[:] = 0
    jg = tp.jax_graph(tg)
    _no_sets(jg, x, "conv_graph_wzp, conv zero points 0")
    want = np.asarray(jbuilder.build(jg, backend="fused").predict_inner(x))
    got = build(tg, backend="fused", device="cpu").predict_inner(x).numpy()
    _assert_rule(got, want, True, "conv_graph_wzp, conv zero points 0, vs JAX fused")


def test_segment_kernel_on_cpu_is_the_plain_chain():
    """On a CPU tensor a segment runs ``segment_reference``; the forward
    counts no launch; the plan buffer is made for the card's layout."""
    from microflow_tpu_torch.kernels import LAUNCHES

    fwd = build_fused_forward(tparse(model_path("person_detect")), device="cpu")
    (seg,) = fwd.segments
    assert seg.plan is None and seg.smem_a + seg.smem_b == 36864 + 18432
    assert seg.segment.macs() == 7_157_888
    x = torch.from_numpy(np.random.default_rng(2).integers(-128, 128, (3, 96, 96, 1),
                                                           dtype=np.int8))
    before = sum(LAUNCHES.values())
    assert torch.equal(seg(x), seg.reference(x))
    assert fwd(x).shape == (3, 2) and sum(LAUNCHES.values()) == before
    buf, _, _ = tmega.pack_segment(seg.segment)
    desc = buf[: 29 * tmega.NF * 4].view(np.int32).reshape(29, tmega.NF)
    kinds = ["dw"] + ["dw", "pw"] * 13 + ["pool", "pw"]
    assert [tmega.op_kind(layer, shp[0]) for layer, shp in
            zip(seg.segment.layers, seg.segment.shapes)] == kinds
    assert desc[:, tmega.F_KIND].tolist() == [tmega.KINDS[k] for k in kinds]


def test_too_large_segment_raises():
    """The port's own rule: a segment whose per-sample pair of tensors does
    not fit one block's shared memory raises at build."""
    tg = chip_smoke.packed_graph(np.random.default_rng(0))
    big = tmega.Segment(tg.layers[:1], (400, 400, 1), (200, 200, 16), None,
                        [((400, 400, 1), (200, 200, 16))])
    with pytest.raises(ValueError, match="shared memory"):
        tmega.pack_segment(big)
