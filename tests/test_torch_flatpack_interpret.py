"""The port's flat kernel's plain version against the JAX package's flat
kernel run in Pallas interpret mode (``tests/test_flatpack.py`` runs it so),
under the rule of ``tests/test_torch_flatpack.py``: at a fixed seed the
FMA and ``exact2``-corner sets along the JAX XLA chain are empty, so the
two agree bit for bit (a final softmax within one LSB: the JAX kernel sums
its entries in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity as tp

from microflow_tpu.compiler.builder import init_params as j_init_params
from microflow_tpu.frontend import parse as jparse
from microflow_tpu.kernels import flatpack as jflat
from microflow_tpu.models import synth
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.kernels import build_flat_kernel
from microflow_tpu_torch.models import model_path

BUNDLED = ("sine", "speech", "person_detect")


def _path(name, tmp_path):
    if name in BUNDLED:
        return model_path(name)
    return synth.write(str(tmp_path / f"{name}.tflite"), getattr(synth, name)())


@pytest.mark.parametrize("name,max_layers", [
    ("sine", None), ("speech", None), ("flat_conv", None), ("person_detect", 3)])
def test_plain_matches_jax_flat_kernel(name, max_layers, tmp_path):
    """The plain version against the JAX flat kernel in Pallas interpret
    mode, batch 8 (``tests/test_flatpack.py`` runs it so)."""
    path = _path(name, tmp_path)
    jg, tg = jparse(path, frontend="python"), tparse(path)
    x = np.random.default_rng(7).integers(-128, 128, (8, *jg.input_shape), dtype=np.int8)
    x2 = x.reshape(8, -1)
    jfn, n, jmeta = jflat.build_flat_kernel(jg, tb=8, interpret=True, max_layers=max_layers)
    off = jmeta["out_off"]
    want = np.asarray(jfn(jnp.asarray(x2)))[:, off:off + jmeta["out_lanes"]]
    counts = tp.chain_sets(jg, j_init_params(jg), x, n)
    counts.pop("outputs")
    assert not any(counts.values()), f"{name}: pick another seed, the sets are not empty: {counts}"
    flat_fn, tn, meta = build_flat_kernel(tg, max_layers=max_layers, device="cpu")
    assert tn == n and meta["out_lanes"] == jmeta["out_lanes"]
    got = flat_fn(torch.from_numpy(x2)).numpy()
    assert got.dtype == np.int8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    if type(tg.layers[n - 1]).__name__ == "SoftmaxLayer":
        assert diff.max() <= 1, name
    else:
        assert diff.max() == 0, name
