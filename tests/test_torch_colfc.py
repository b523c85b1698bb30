"""The port's column-FC kernel on the CPU (``microflow_tpu_torch/kernels/
colfc.py``: its plan and its plain torch version) against the JAX
package's ``kernels/colfc.py`` run in Pallas interpret mode, as
``tests/test_colfc.py`` runs it, on sine and on fabricated FC chains.

The rule is ``tests/torch_parity.py``'s; at each fixed seed the FMA and
``exact2``-corner sets along the JAX XLA chain are asserted empty, and the
port must then equal the JAX kernel bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
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


def test_f32_bound_and_packed_plan():
    plan = tcolfc.plan_col(tparse(model_path("sine")))
    assert tcolfc.f32_exact(plan)
    wt, d, b0, c1, lo, hi = plan[0]
    assert not tcolfc.f32_exact([(wt, np.full_like(d, 2**24 - 1), b0, c1, lo, hi)])
    buf = tcolfc.pack_col_plan(plan, "i32")
    header = buf[:len(plan) * tcolfc.HEADER].reshape(len(plan), tcolfc.HEADER)
    assert header[:, :4].tolist() == [[1, 16, 8, 16], [16, 16, 16, 16], [16, 1, 16, 8]]
    off = header[1, 6]  # layer 1's W_T, [16][16] words
    assert np.array_equal(buf[off:off + 256].reshape(16, 16), plan[1][0])
    assert np.array_equal(tcolfc.pack_col_plan(plan, "f32")[off:off + 256].view(np.float32),
                          plan[1][0].reshape(-1).astype(np.float32))
