"""The port's column-FC kernel on the CPU (``microflow_tpu_torch/kernels/
colfc.py``: its plan and its plain torch version) against the JAX
package's ``kernels/colfc.py`` run in Pallas interpret mode, as
``tests/test_colfc.py`` runs it, on sine and on fabricated FC chains.

The rule is ``tests/torch_parity.py``'s; at each fixed seed the FMA and
``exact2``-corner sets along the JAX XLA chain are asserted empty, and the
port must then equal the JAX kernel bit for bit.

The CUDA kernel's indexing (``csrc/colfc.cu``) is replayed by
``tests/torch_emulators.py::colfc_mma`` from the packed plan, and held
bit-equal to the plain version on sine, the fabricated chains here and in
``chip_smoke.COL_CHAINS``, and random chains, at batches around an m-tile.
"""

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_emulators as em
import torch_parity as tp

from microflow_tpu.compiler.builder import init_params as j_init_params
from microflow_tpu.frontend import parse as jparse
from microflow_tpu.frontend.tflite import ActivationFunctionType as Act
from microflow_tpu.frontend.tflite import BuiltinOperator as Op
from microflow_tpu.frontend.tflite import TensorType
from microflow_tpu.frontend.writer import ModelWriter
from microflow_tpu.kernels import colfc as jcolfc
from microflow_tpu_torch import compile_tflite
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.kernels import build_col_kernel
from microflow_tpu_torch.kernels import colfc as tcolfc
from microflow_tpu_torch.models import GOLDENS, model_path

I8, I32 = TensorType.INT8, TensorType.INT32
CHAINS = {  # seed: (dims, activations), as tests/test_colfc.py fabricates them
    0: ((1, 16, 16, 1), (Act.NONE, Act.RELU, Act.NONE)),
    1: ((4, 8, 2), (Act.RELU6, Act.NONE)),
    2: ((32, 32, 32), (Act.RELU, Act.RELU6)),
    3: ((3, 5, 7), (Act.NONE, Act.RELU)),
}


def _fc_chain(path: str, seed: int) -> str:
    dims, acts = CHAINS[seed]
    rng = np.random.default_rng(seed)
    m = ModelWriter(f"colfc-{seed}")
    cur = m.tensor([1, dims[0]], I8, 0.04, int(rng.integers(-64, 64)), name="input")
    x_in = cur
    for i, (k, n) in enumerate(zip(dims, dims[1:])):
        wq = rng.integers(-127, 128, (n, k), dtype=np.int8)
        w_t = m.tensor([n, k], I8, 0.02, 0, data=wq, name=f"w{i}")
        b_t = m.tensor([n], I32, 0.0008, 0, data=rng.integers(-500, 500, n, dtype=np.int32),
                       name=f"b{i}")
        y = m.tensor([1, n], I8, float(rng.uniform(0.01, 0.08)), int(rng.integers(-128, 64)),
                     name=f"y{i}")
        m.add_op(Op.FULLY_CONNECTED, [cur, w_t, b_t], [y], m.fc_options(acts[i]))
        cur = y
    with open(path, "wb") as f:
        f.write(m.finish([x_in], [cur]))
    return path


@pytest.mark.parametrize("compute", ["i32", "f32"])
@pytest.mark.parametrize("case", ["sine", 0, 1, 2, 3])
def test_plain_matches_jax_colfc_kernel(case, compute, tmp_path):
    path = (model_path("sine") if case == "sine"
            else _fc_chain(str(tmp_path / f"fc{case}.tflite"), case))
    jg, tg = jparse(path, frontend="python"), tparse(path)
    jfn, jmeta = jcolfc.build_col_kernel(jg, tb=2, interpret=True, compute=compute)
    fn, meta = build_col_kernel(tg, compute=compute, device="cpu")
    assert (meta["k0"], meta["n_out"]) == (jmeta["k0"], jmeta["n_out"])
    assert meta["compute"] == compute  # every chain here is inside the f32 bound
    seed = 100 if case == "sine" else 101 + case
    x = np.random.default_rng(seed).integers(-128, 128, (256, meta["k0"]), dtype=np.int8)
    counts = tp.chain_sets(jg, j_init_params(jg), x)
    counts.pop("outputs")
    assert not any(counts.values()), f"pick another seed, the sets are not empty: {counts}"
    want = np.asarray(jfn(jnp.asarray(x.T.copy()))).T
    got = fn(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int8 and np.array_equal(got, want)


def test_sine_golden_through_colfc():
    x, want = GOLDENS["sine"]
    m = compile_tflite(model_path("sine"), name="sine", backend="colfc", device="cpu")
    assert m.backend == "colfc"
    assert np.array_equal(m.predict(x).numpy(), want)
    ref = compile_tflite(model_path("sine"), backend="xla", device="cpu")
    xq = torch.from_numpy(np.random.default_rng(3).integers(-128, 128, (37, 1), dtype=np.int8))
    assert torch.equal(m.predict_inner(xq), ref.predict_inner(xq))


def test_colfc_rejects_graphs_that_are_no_tiny_fc_chain():
    with pytest.raises(ValueError, match="colfc-packable"):
        compile_tflite(model_path("person_detect"), backend="colfc", device="cpu")
    assert tcolfc.plan_col(tparse(model_path("speech"))) is None  # a conv layer, K = 4000
    with pytest.raises(ValueError, match="compute"):
        build_col_kernel(tparse(model_path("sine")), compute="f16", device="cpu")


BATCHES = (0, 1, 15, 16, 17, 100)  # around an m-tile of 16 samples and a work item


def _emulated(plan, x: np.ndarray, **offsets) -> np.ndarray:
    return em.colfc_mma(tcolfc.pack_col_plan(plan), x, len(plan), plan[-1][0].shape[0],
                        **offsets)


def _input(rng, b: int, k0: int) -> np.ndarray:
    x = rng.integers(-128, 128, (b, k0), dtype=np.int8)
    x.flat[:2] = (-128, 127)[:x.size]  # both int8 rails
    return x


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("case", ["sine", 0, 1, 2, 3])
def test_emulated_kernel_matches_plain(case, batch, tmp_path):
    path = (model_path("sine") if case == "sine"
            else _fc_chain(str(tmp_path / f"fc{case}.tflite"), case))
    plan = tcolfc.plan_col(tparse(path))
    x = _input(np.random.default_rng(batch), batch, plan[0][0].shape[1])
    want = tcolfc.colfc_reference(plan, torch.from_numpy(x)).numpy()
    assert np.array_equal(_emulated(plan, x), want)


@pytest.mark.parametrize("spec", chip_smoke.COL_CHAINS, ids=[c[0] for c in chip_smoke.COL_CHAINS])
def test_emulated_kernel_matches_plain_on_smoke_chains(spec):
    """The chains ``chip_smoke.py`` runs on the card, at its batches, with x
    and the output aligned and one byte off."""
    rng = np.random.default_rng(7)
    plan = tcolfc.plan_col(chip_smoke.col_chain_graph(rng, *spec))
    for b in (0, 1, 15, 17, 1000):
        x = _input(rng, b, plan[0][0].shape[1])
        want = tcolfc.colfc_reference(plan, torch.from_numpy(x)).numpy()
        for off in (0, 1):
            assert np.array_equal(_emulated(plan, x, x_off=off, out_off=off), want), (b, off)


@pytest.mark.parametrize("seed", range(12))
def test_emulated_kernel_matches_plain_on_random_chains(seed):
    """K0 and the widths drawn from 1..32, 1-5 layers, in_zp != 0, c1 per
    channel (every other seed), NONE/RELU/RELU6; x and the output at 0-3
    bytes past an aligned address.  Every third seed draws K0 from 1..4
    and the last width from 1..2 (the kernel's narrow paths)."""
    rng = np.random.default_rng(1000 + seed)
    n_layers = int(rng.integers(1, 6))
    narrow = seed % 3 == 0
    widths = tuple(int(w) for w in rng.integers(1, 33, n_layers))
    if narrow:
        widths = widths[:-1] + (int(rng.integers(1, 3)),)
    acts = tuple(rng.choice(["NONE", "RELU", "RELU6"], n_layers))
    in_zp = int(rng.choice([-128, 127, *rng.integers(-127, 127, 3)]) or 1)
    k0 = int(rng.integers(1, 5 if narrow else 33))
    g = chip_smoke.col_chain_graph(rng, f"random{seed}", k0, widths, acts, in_zp, seed % 2 == 0)
    plan = tcolfc.plan_col(g)
    assert len(plan) == n_layers
    for b in BATCHES:
        x = _input(rng, b, k0)
        want = tcolfc.colfc_reference(plan, torch.from_numpy(x)).numpy()
        x_off, out_off = (int(v) for v in rng.integers(0, 4, 2))
        assert np.array_equal(_emulated(plan, x, x_off=x_off, out_off=out_off), want), b


@pytest.mark.parametrize("nt", [1, 2, 3, 4])
def test_feature_order_is_the_packing_of_c_into_a(nt):
    """Each C register's column, packed into the next A by the kernel's
    steps (``pack_tiles``) for a layer of nt n-tiles, lands at every A
    position p of rows g and g+8 as feature ``feature_order()[p]`` (where
    that feature is one of the layer's; the other positions meet zero rows
    of the next layer's W)."""
    lane_col = 2 * em.T[:, None] + np.arange(4)[None, :] % 2  # column of C register i
    q = {j: np.broadcast_to(8 * j + lane_col, (1, 32, 4)).astype(np.int64) for j in range(nt)}
    a = em.pack_tiles(q, nt)[0]
    A = np.zeros((16, 32), np.int64)
    A[em.A_ROW, em.A_COL] = em.signed_bytes(a).reshape(32, 16)
    pi = tcolfc.feature_order()
    live = pi < 8 * nt
    assert (A[:, live] == pi[None, live]).all()
    assert sorted(pi) == list(range(32))


def test_f32_bound_and_packed_plan():
    plan = tcolfc.plan_col(tparse(model_path("sine")))
    assert tcolfc.f32_exact(plan)
    wt, d, b0, c1, lo, hi = plan[0]
    assert not tcolfc.f32_exact([(wt, np.full_like(d, 2**24 - 1), b0, c1, lo, hi)])
    buf = tcolfc.pack_col_plan(plan)
    n = len(plan)
    header = buf[:n * tcolfc.HEADER].reshape(n, tcolfc.HEADER)
    assert header[:, 0].tolist() == [2, 2, 1]  # n-tiles of 8 features
    assert header[:, 1:3].view(np.float32).tolist() == [list(p[4:6]) for p in plan]
    assert header[:, 3].tolist() == [12, 12 + 88 * 2, 12 + 88 * 4]
    assert buf.size == 12 + 88 * 5 and buf.size % 4 == 0
    # layer 1's B fragments: lane 4g+t, byte i of word w holds K position
    # 4t + i + 16w of column 8j+g, i.e. feature feature_order()[position]
    off = header[1, 3]
    frag = buf[off:off + 128].view(np.int8).reshape(2, 32, 8).astype(np.int64)
    w1, pi = plan[1][0].T, tcolfc.feature_order()  # [K 16, N 16]
    for j in range(2):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            pos = 4 * t + np.arange(8) % 4 + 16 * (np.arange(8) // 4)
            want = np.where(pi[pos] < 16, w1[np.minimum(pi[pos], 15), 8 * j + g], 0)
            assert frag[j, lane].tolist() == want.tolist()
    for k, arr in enumerate((plan[1][1], plan[1][2], plan[1][3])):
        got = buf[off + 128 + 16 * k:off + 144 + 16 * k]
        assert np.array_equal(got if k == 0 else got.view(np.float32), arr[:, 0])
    # the last layer (N = 1): its column repeated over all 8 of its n-tile
    off2 = header[2, 3]
    frag2 = buf[off2:off2 + 64].view(np.int8).reshape(32, 8).astype(np.int64)
    w2 = plan[2][0][0]  # [K 16]
    pos = 4 * (np.arange(32) & 3)[:, None] + np.arange(8) % 4 + 16 * (np.arange(8) // 4)
    assert frag2.tolist() == np.where(pi[pos] < 16, w2[np.minimum(pi[pos], 15)], 0).tolist()
    for k, arr in enumerate((plan[2][1], plan[2][2], plan[2][3])):
        got = buf[off2 + 64 + 8 * k:off2 + 72 + 8 * k]
        assert (got if k == 0 else got.view(np.float32)).tolist() == [arr[0, 0]] * 8
    # layer 0 reads x in order: K position 0 of column 8j+g is W[0, 8j+g]
    frag0 = buf[header[0, 3]:header[0, 3] + 128].view(np.int8).reshape(2, 32, 8)
    assert frag0[:, ::4, 0].tolist() == plan[0][0][:, 0].reshape(2, 8).tolist()
    assert not frag0[:, :, 1:].any() and not frag0[:, 1::4].any()
