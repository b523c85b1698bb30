"""The torch port's numeric core against the JAX package's and the
reference semantics: round half away from zero, saturating casts that
clamp before they convert, quantize/dequantize association order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microflow_tpu.core import numerics as jnum
from microflow_tpu.core.quantize import dequantize as j_dequantize
from microflow_tpu.core.quantize import quantize as j_quantize
from microflow_tpu.core.activation import FusedActivation as JAct
from microflow_tpu.core.activation import quantize_scalar as j_quantize_scalar
from microflow_tpu_torch.core import numerics as tnum
from microflow_tpu_torch.core.quantize import dequantize, quantize
from microflow_tpu_torch.core.activation import (
    FusedActivation,
    activation_bounds,
    apply_fused_activation,
    quantize_scalar,
)

H = np.float32(0.5) - np.float32(2.0**-25)  # the f32 just below 0.5


def test_round_away_ties_and_near_ties():
    x = np.array([0.5, -0.5, H, -H, 1.5, -1.5, 2.5, -2.5, 0.49999997, 3.4999998, -0.0,
                  1e9, -1e9, 2.0**23 + 1], np.float32)
    want = np.array([1, -1, 0, -0.0, 2, -2, 3, -3, 0, 3, -0.0, 1e9, -1e9, 2.0**23 + 1],
                    np.float32)
    got = tnum.round_away(torch.from_numpy(x)).numpy()
    assert got.tobytes() == want.tobytes()  # -0.0 keeps its sign, as roundf does
    assert got.tobytes() == np.asarray(jnum.round_away(jnp.asarray(x))).tobytes()


def test_torch_round_is_not_round_away():
    """Why the port cannot use torch.round: it rounds half to even."""
    x = torch.tensor([0.5, 1.5, 2.5, -0.5])
    assert torch.round(x).tolist() == [0.0, 2.0, 2.0, -0.0]
    assert tnum.round_away(x).tolist() == [1.0, 2.0, 3.0, -1.0]


def test_round_away_random_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 300, 20000),
                        rng.integers(-500, 500, 2000) + 0.5]).astype(np.float32)
    x = np.concatenate([x, np.nextafter(x, np.float32(0)), np.nextafter(x, np.float32(1e9))])
    got = tnum.round_away(torch.from_numpy(x)).numpy()
    assert got.tobytes() == np.asarray(jnum.round_away(jnp.asarray(x))).tobytes()


@pytest.mark.parametrize("dtype,np_dtype", [(torch.int8, np.int8), (torch.uint8, np.uint8),
                                            (torch.int16, np.int16)])
def test_saturating_cast(dtype, np_dtype):
    x = np.array([-1e9, -70000, -129, -128, -1, 0, 127, 128, 255, 256, 70000, 1e9], np.float32)
    got = tnum.saturating_cast(torch.from_numpy(x), dtype)
    assert got.dtype == dtype
    info = np.iinfo(np_dtype)
    assert np.array_equal(got.numpy(), np.clip(x, info.min, info.max).astype(np_dtype))
    assert np.array_equal(got.numpy(), np.asarray(jnum.saturating_cast(jnp.asarray(x), np_dtype)))


def test_quantize_saturates_and_matches_jax():
    assert quantize(torch.tensor([1e9]), 0.1, 0).item() == 127
    assert quantize(torch.tensor([-1e9]), 0.1, 0).item() == -128
    assert quantize(torch.tensor([1e9]), 0.1, 0, dtype=torch.uint8).item() == 255
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, 5000).astype(np.float32)
    for scale, zp, dt in ((0.02457398, -128, np.int8), (1 / 64, 128, np.uint8), (0.37, 5, np.int8)):
        got = quantize(torch.from_numpy(x), scale, zp, dtype=tnum.torch_dtype(dt)).numpy()
        assert np.array_equal(got, np.asarray(j_quantize(jnp.asarray(x), scale, zp, dtype=dt)))


def test_dequantize_association():
    q = np.arange(-128, 128, dtype=np.int8)
    got = dequantize(torch.from_numpy(q), 0.00390625, -128).numpy()
    want = np.float32(0.00390625) * (q.astype(np.float32) - np.float32(-128))
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == np.asarray(j_dequantize(jnp.asarray(q), 0.00390625, -128)).tobytes()


@pytest.mark.parametrize("scale,zp", [(0.0235, -128), (0.05, 4), (0.02, -100), (0.3, 100)])
def test_relu6_bound_and_activations(scale, zp):
    assert quantize_scalar(6.0, scale, zp) == j_quantize_scalar(6.0, scale, zp)
    x = torch.arange(-128, 128, dtype=torch.int8)
    for act in FusedActivation:
        lo, hi = activation_bounds(act, scale, zp)
        got = apply_fused_activation(x, act, scale, zp)
        assert torch.equal(got, torch.clamp(x, lo, hi))
        assert act.value == JAct(act.value).value
