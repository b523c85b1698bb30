"""The port's flat whole-network kernel on the CPU
(``microflow_tpu_torch/kernels/flatpack.py``: its plan and its plain torch
version) against the JAX package's ``kernels/flatpack.py``.

The rule is ``tests/torch_parity.py``'s: bit-equal except on the elements
where the JAX package, run by XLA on the CPU, contracts an epilogue into an
FMA, or where its XLA ops round half away from zero and the kernels'
``exact2`` does not (y = +-(0.5 - 2**-25)); a final softmax may differ by
one LSB (the JAX kernel sums its entries in another order).  A whole-chain
comparison at a fixed seed first counts those sets along the JAX XLA chain
and asserts that they are empty; it then demands bit-equality.
"""

import numpy as np
import pytest
import torch
import torch_parity as tp

from microflow_tpu.compiler.builder import init_params as j_init_params
from microflow_tpu.frontend import parse as jparse
from microflow_tpu.kernels import flatpack as jflat
from microflow_tpu.models import synth
from microflow_tpu_torch import compile_tflite
from microflow_tpu_torch.compiler.builder import resolve_backend
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.kernels import build_flat_kernel, flat_forward_reference
from microflow_tpu_torch.kernels import flatpack as tflat
from microflow_tpu_torch.models import GOLDENS, model_path

BUNDLED = ("sine", "speech", "person_detect")
PD = model_path("person_detect")


def _path(name, tmp_path):
    if name in BUNDLED:
        return model_path(name)
    return synth.write(str(tmp_path / f"{name}.tflite"), getattr(synth, name)())


def _no_sets(counts: dict, what: str) -> None:
    sets = {k: v for k, v in counts.items() if k != "outputs"}
    assert not any(sets.values()), f"{what}: pick another seed, the sets are not empty: {sets}"


@pytest.mark.parametrize("name,max_layers,want", [
    ("sine", None, 3), ("speech", None, 4), ("person_detect", None, 31),
    ("person_detect", 2, 2), ("person_detect", 5, 5), ("person_detect", 12, 12),
    ("person_detect", 28, 28), ("flat_conv", None, 7), ("lenet", None, 8),
    ("per_channel_dw", None, 4), ("uint8_mlp", None, None), ("full_ops", None, None),
])
def test_n_layers_matches_jax_plan(name, max_layers, want, tmp_path):
    path = _path(name, tmp_path)
    jplan = jflat.plan_flat(jparse(path, frontend="python"), max_layers=max_layers)
    tplan = tflat.plan_flat(tparse(path), max_layers=max_layers)
    assert (None if jplan is None else jplan[1]) == want
    assert (None if tplan is None else tplan[1]) == want
    if tplan is not None:
        ops, n, meta = tplan
        assert meta["out_lanes"] == ops[-1].lanes_out == int(np.prod(meta["out_shape"]))


def test_person_detect_matches_jax_xla_chain():
    """The whole model through ``backend="flat"`` against the JAX XLA layer
    chain at batch 4; the prefix before the softmax bit for bit."""
    jg = jparse(PD, frontend="python")
    x = np.random.default_rng(12).integers(-128, 128, (4, 96, 96, 1), dtype=np.int8)
    counts = tp.chain_sets(jg, j_init_params(jg), x)
    _no_sets(counts, "person_detect")
    outs = counts["outputs"]
    m = compile_tflite(PD, backend="flat", device="cpu")
    got = m.predict_inner(torch.from_numpy(x)).numpy().astype(np.int64)
    assert got.shape == outs[-1].shape and np.abs(got - outs[-1]).max() <= 1
    flat_fn, n, _ = build_flat_kernel(m.graph, max_layers=29, device="cpu")
    assert n == 29
    pre = flat_fn(torch.from_numpy(x.reshape(4, -1))).numpy()
    assert np.array_equal(pre, outs[28].reshape(4, -1))


@pytest.mark.parametrize("name", BUNDLED)
def test_golden_bit_exact_through_flat(name):
    x, want = GOLDENS[name]
    m = compile_tflite(model_path(name), name=name, backend="flat", device="cpu")
    assert m.backend == "flat"
    got = m.predict(x)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def test_prefix_then_tail_equals_xla():
    """A 12-layer prefix and CompiledModel's own tail code after it (the port
    reads no environment variable, so the test hands the prefix over)."""
    m = compile_tflite(PD, backend="flat", device="cpu")
    m._flat = build_flat_kernel(m.graph, max_layers=12, device="cpu")
    assert m._flat[1] == 12 and m._flat[2]["out_shape"] == (6, 6, 64)
    ref = compile_tflite(PD, backend="xla", device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).integers(-128, 128, (3, 96, 96, 1),
                                                           dtype=np.int8))
    assert torch.equal(m.predict_inner(x), ref.predict_inner(x))


def test_exact_mode_equals_xla():
    """``requant="exact"`` rounds as the plain ops do, softmax included (both
    sum left to right), so it equals the ``xla`` backend everywhere."""
    g = tparse(model_path("speech"))
    flat_fn, n, _ = build_flat_kernel(g, requant="exact", device="cpu")
    ref = compile_tflite(model_path("speech"), backend="xla", device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).integers(-128, 128, (64, 1960), dtype=np.int8))
    assert n == 4 and torch.equal(flat_fn(x), ref.predict_inner(x))


def test_exact2_epilogue_corner_and_fma_triples():
    """The plain epilogue is ``exact2`` (+-1 at y = +-(0.5 - 2**-25), where
    ``exact`` gives 0) and a multiply then an add, never an FMA."""
    corner = np.float32(0.5) - np.float32(2.0**-25)
    b0 = torch.tensor([corner, -corner, 0.5, -0.5, 2.5], dtype=torch.float32)
    acc = torch.zeros((1, 5), dtype=torch.int32)
    one = torch.ones(5)
    assert tflat._requant(acc, b0, one, -128, 127, "exact2").tolist() == [[1, -1, 1, -1, 3]]
    assert tflat._requant(acc, b0, one, -128, 127, "exact").tolist() == [[0, 0, 1, -1, 3]]
    q, b, c = tp.fma_sensitive(np.random.default_rng(2), 16)
    sep, fma = tp.epilogue_pair(c, q.astype(np.float32), b, -128, 127, rounding="exact2")
    got = tflat._requant(torch.from_numpy(q)[None, :], torch.from_numpy(b), torch.from_numpy(c),
                         -128, 127, "exact2")[0].numpy()
    assert np.array_equal(got, sep) and not np.array_equal(got, fma)


def _unpack_mma_fragments(raw: np.ndarray, oc: int, ic: int) -> np.ndarray:
    """int8 [OC, IC] from the A fragments of a tensor-core 1x1 conv:
    [OC/16][ceil(IC/32)][32 lanes][16 bytes]; while more than 32 channels
    remain from kb, two units hold channels kb + 16t + (0 | 8) .. +7 in
    lane 4g + t, else one unit holds kb + 8t .. +7; the 16 bytes are rows
    g, g+8 of the first 4 channels, then rows g, g+8 of the next 4."""
    starts = []
    for kb in range(0, ic, 64):
        starts += [(kb, 16), (kb + 8, 16)] if ic - kb > 32 else [(kb, 8)]
    frag = raw[:oc * len(starts) * 32].view(np.int8).reshape(oc // 16, len(starts), 32, 16)
    w = np.zeros((oc, ic + 64), np.int8)
    hits = np.zeros(w.shape, np.int64)
    for m in range(oc // 16):
        for u, (kb, step) in enumerate(starts):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                c = kb + step * t
                for part, (r, c0) in enumerate(((g, c), (g + 8, c), (g, c + 4), (g + 8, c + 4))):
                    w[16 * m + r, c0:c0 + 4] = frag[m, u, lane, 4 * part:4 * part + 4]
                    hits[16 * m + r, c0:c0 + 4] += 1
    assert (hits[:, :ic] == 1).all() and not w[:, ic:].any()
    return w[:, :ic]


def test_device_plan_layout():
    """The kernel's buffer for person_detect: one descriptor per op, each
    op's constants 16-byte aligned inside the buffer, the ping-pong split
    18,432 + 36,864 bytes."""
    ops, n, meta = tflat.plan_flat(tparse(PD))
    buf, split = tflat.pack_plan(ops)
    desc = buf[:len(ops) * tflat.NF * 4].view(np.int32).reshape(len(ops), tflat.NF)
    assert [int(k) for k in desc[:, tflat.F_KIND]] == [tflat.KINDS[op.kind] for op in ops]
    assert (split["smem_a"], split["smem_b"]) == (36864, 18432)
    for row, op in zip(desc, ops):
        assert (row[tflat.F_IN], row[tflat.F_OUT]) == (op.lanes_in, op.lanes_out)
        for field in (tflat.F_W, tflat.F_D, tflat.F_BIAS, tflat.F_C1, tflat.F_RECIP):
            assert row[field] % 16 == 0 and row[field] < buf.size
        if op.kind == "dw":
            kh, kw, c = op.weights.shape
            # every dw op is 3x3 at stride 1 or 2: all take the 3x3 path
            assert row[tflat.F_DW3] == (tflat.DW3_STEM if op.in_shape[2] == 1
                                        else op.geom.stride_rows) and not row[tflat.F_VEC]
            words = buf[row[tflat.F_W]:row[tflat.F_W] + 3 * 4 * c].view(np.int32).reshape(3, c)
            taps = words.view(np.int8).reshape(3, c, 4).transpose(0, 2, 1)  # [dh, dw + pad, c]
            assert np.array_equal(taps[:, :3], op.weights) and not taps[:, 3].any()
            d = buf[row[tflat.F_D]:row[tflat.F_D] + 4 * c].view(np.int32)
            assert np.array_equal(d, -op.in_zp * op.weights.reshape(-1, c).astype(np.int32).sum(0))
        if op.kind == "pw":
            fm, c = op.weights.shape[0], op.weights.shape[3]
            assert row[tflat.F_MMA] == (fm % 16 == 0)  # layers 2-26, not the head
            if row[tflat.F_MMA]:
                unpacked = _unpack_mma_fragments(buf[row[tflat.F_W]:], fm, c)
            else:
                words = buf[row[tflat.F_W]:row[tflat.F_W] + fm * c].view(np.int32)
                unpacked = words.view(np.int8).reshape(c // 4, fm, 4).transpose(1, 0, 2)
            assert np.array_equal(unpacked.reshape(fm, 1, 1, c), op.weights)
            d = buf[row[tflat.F_D]:row[tflat.F_D] + 4 * fm].view(np.int32)
            assert np.array_equal(d, -op.in_zp * op.weights.reshape(fm, c).astype(np.int32).sum(1))
    nbytes, ops_count = tflat.flat_bound(ops, 8192)
    assert ops_count == 2 * 8192 * 7_157_888
    assert nbytes == 8192 * (9216 + 2) + 207_968


def test_plain_version_on_an_empty_batch():
    flat_fn, _, meta = build_flat_kernel(tparse(PD), device="cpu")
    out = flat_forward_reference(flat_fn.ops, torch.zeros((0, meta["in_lanes"]), dtype=torch.int8))
    assert out.shape == (0, 2) and out.dtype == torch.int8


def test_errors(tmp_path):
    u8 = synth.write(str(tmp_path / "u8.tflite"), synth.uint8_mlp())
    with pytest.raises(ValueError, match="flat-packable"):
        compile_tflite(u8, backend="flat", device="cpu")
    g = tparse(PD)
    # "fixed" is ported: it plans and builds (tests/test_torch_flatpack_fixed.py)
    flat_fn, n, meta = build_flat_kernel(g, requant="fixed", device="cpu")
    assert (flat_fn.requant, flat_fn.launch_key, n, meta["out_lanes"]) == (
        "fixed", "flatpack_fixed", 31, 2)
    # so are the measurement-only "raw" and "noround", each its own
    # instantiation (tests/test_torch_flatpack_modes.py holds them to JAX)
    for mode in ("raw", "noround"):
        flat_fn, n, meta = build_flat_kernel(g, requant=mode, device="cpu")
        assert (flat_fn.requant, flat_fn.launch_key, n, meta["out_lanes"]) == (
            mode, f"flatpack_{mode}", 31, 2)
    with pytest.raises(ValueError, match="unknown requant"):
        build_flat_kernel(g, requant="nearest", device="cpu")


def test_auto_resolves_as_the_jax_package(tmp_path):
    for name, want in (("person_detect", "flat"), ("speech", "flat"), ("sine", "pallas")):
        g = tparse(model_path(name))
        assert resolve_backend(g, "cuda") == want
        assert resolve_backend(g, "cpu") == "xla"
    # a non-int8 graph runs on CUDA only where the caller asks for "xla"
    u8 = tparse(synth.write(str(tmp_path / "u8.tflite"), synth.uint8_mlp()))
    assert resolve_backend(u8, "cpu") == "xla"
    with pytest.raises(ValueError, match="backend 'pallas' runs int8 graphs only"):
        resolve_backend(u8, "cuda")
