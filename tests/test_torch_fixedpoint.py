"""The port's fixed-point requant (``microflow_tpu_torch/core/fixedpoint.py``
and ``compiler/fixed_forward.py``) against the JAX package's.

``quantize_multiplier(s)`` and ``derive_bias_q`` must agree bit for bit, on
a list of scales and on every channel of every MAC layer of the bundled
models, so the (M, S, bias_q) behind ``analysis/data/fixed_error.csv`` are
the port's too.  ``requant_fixed`` and the fixed forward must agree bit for
bit under one rule: the JAX package makes ``2**S`` and ``2**(S-1)`` with
``jnp.exp2``, which XLA's CPU backend computes a few ulps off at some
shifts; the port uses exact powers of two.  So the port must equal the JAX
function with ``jnp.exp2`` made exact, and the JAX function as it is
outside the elements whose rounding that error moves (counted here, in
numpy, from the same inputs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microflow_tpu.compiler.builder import init_params as j_init_params
from microflow_tpu.compiler.fixed_forward import build_fixed_forward as j_build_fixed_forward
from microflow_tpu.core import fixedpoint as jfp
from microflow_tpu.core.activation import FusedActivation as JAct
from microflow_tpu.frontend import parse as jparse
from microflow_tpu_torch.compiler.builder import apply_layer, params_from_numpy
from microflow_tpu_torch.compiler.fixed_forward import build_fixed_forward
from microflow_tpu_torch.compiler.ir import Conv2DLayer, DepthwiseConv2DLayer, FullyConnectedLayer
from microflow_tpu_torch.core import fixedpoint as tfp
from microflow_tpu_torch.core.activation import FusedActivation, activation_bounds
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.models import model_path

F32 = np.float32
MODELS = ("sine", "speech", "person_detect")
SHAPES = {"sine": (64, 1), "speech": (4, 1960), "person_detect": (2, 96, 96, 1)}
C1_LIST = (0.5, 0.004311, 1.7e-3, 0.9999, 123.4, 1e-8, 0.0, 2.0**-20, 3.0e-5, 1.0,
           float(np.nextafter(F32(0.5), F32(0))), 40000.0, float("inf"), float("nan"))
MAC = (FullyConnectedLayer, Conv2DLayer, DepthwiseConv2DLayer)


def exact_exp2(v):
    """``2**v`` for integral f32 ``v`` in the normal range, exactly."""
    return jax.lax.bitcast_convert_type((v.astype(jnp.int32) + 127) << 23, jnp.float32)


def _mac_layers(name):
    jg = jparse(model_path(name), frontend="python")
    tg = tparse(model_path(name))
    return jg, tg, [(lj, lt) for lj, lt in zip(jg.layers, tg.layers) if isinstance(lt, MAC)]


def _c1(layer) -> np.ndarray:
    n = (layer.weights.shape[1] if isinstance(layer, FullyConnectedLayer)
         else layer.filters.shape[0] if isinstance(layer, Conv2DLayer)
         else layer.weights.shape[2])
    c1 = np.atleast_1d(np.asarray(layer.c1, F32))
    return np.array([c1[i] if i < len(c1) else c1[0] for i in range(n)], F32)


def test_quantize_multiplier_matches_jax():
    for c1 in C1_LIST:
        assert tfp.quantize_multiplier(c1) == jfp.quantize_multiplier(c1), c1
    for c1 in (0.5, 0.004311, 1.7e-3, 0.9999, 123.4, 1e-8):  # the JAX test's bound
        m, s = tfp.quantize_multiplier(c1)
        assert abs(m / 2.0**s - c1) <= c1 * 2.0**-14, c1
    tm, ts = tfp.quantize_multipliers(np.array(C1_LIST, F32))
    jm, js = jfp.quantize_multipliers(np.array(C1_LIST, F32))
    assert tm.dtype == jm.dtype == F32 and ts.dtype == js.dtype == np.int32
    assert np.array_equal(tm, jm) and np.array_equal(ts, js)


@pytest.mark.parametrize("name", MODELS)
def test_multipliers_and_bias_q_of_every_channel_match_jax(name):
    """(M, S) and bias_q of every channel of every MAC layer, the weights'
    c0 carried through ``params_from_numpy``."""
    jg, _, macs = _mac_layers(name)
    tparams = params_from_numpy(j_init_params(jg), "cpu")
    assert macs
    for lj, lt in macs:
        c1 = _c1(lt)
        for a, b in zip(tfp.quantize_multipliers(c1), jfp.quantize_multipliers(c1)):
            assert np.array_equal(a, b) and a.dtype == b.dtype, lt.index
        c0 = tparams[f"layer{lt.index}"]["c0"]
        got = tfp.derive_bias_q(c0, c1).numpy()
        want = np.asarray(jfp.derive_bias_q(jnp.asarray(c0.numpy()), c1))
        assert got.dtype == want.dtype == F32
        assert got.tobytes() == want.tobytes(), lt.index


def test_derive_bias_q_rounds_half_to_even_as_jax():
    c1 = np.array([0.5, 0.25, 1.0, 1.0, 1.0, 3e-3, 0.0], F32)
    c0 = np.array([0.25, 0.375, 2.5, -2.5, 3.5, 1.7, 1.0], F32)
    got = tfp.derive_bias_q(torch.from_numpy(c0), c1).numpy()
    want = np.asarray(jfp.derive_bias_q(jnp.asarray(c0), c1))
    assert got.tobytes() == want.tobytes()
    assert got[:5].tolist() == [0.0, 2.0, 2.0, -2.0, 4.0]


def fixed_values(q, bias_q, m, shift, out_zp, lo, hi, half, div) -> np.ndarray:
    """``requant_fixed`` in numpy f32 with the given ``2**(S-1)`` and
    ``2**S``."""
    p = ((q.astype(F32) + bias_q.astype(F32)) * m.astype(F32)).astype(F32)
    mag = np.floor(((np.abs(p) + half).astype(F32) / div).astype(F32))
    y = (np.sign(p) * mag).astype(F32) + F32(out_zp)
    return np.clip(y, lo, hi).astype(np.int64)


def exp2_sensitive(q, bias_q, m, shift, out_zp, lo, hi) -> np.ndarray:
    """Where the JAX package's ``jnp.exp2`` (jitted, on this backend) moves
    the result away from exact powers of two."""
    s = jnp.asarray(shift.astype(F32))
    j_half, j_div = (np.asarray(v) for v in jax.jit(lambda v: (jnp.exp2(v - 1.0), jnp.exp2(v)))(s))
    e_half = np.exp2(shift - 1.0).astype(F32)
    e_div = np.exp2(shift.astype(np.float64)).astype(F32)
    return (fixed_values(q, bias_q, m, shift, out_zp, lo, hi, j_half, j_div)
            != fixed_values(q, bias_q, m, shift, out_zp, lo, hi, e_half, e_div))


def _requant_case(rng, n_ch=64, rows=512):
    """Random accumulators and channel constants, with edges: ties of the
    shift (M = 2**14, S = 15 halves q + bias_q), q past +-2**24, both
    rails, zero."""
    c1 = np.concatenate([[0.5, 0.5, 2.0**-18, 1.0],
                         rng.uniform(1e-5, 0.05, n_ch - 4)]).astype(F32)
    m, s = tfp.quantize_multipliers(c1)
    bias_q = np.round(rng.normal(0, 3000, n_ch)).astype(F32)
    bias_q[:4] = (1, 0, 2**24 + 2**17, 0)
    q = rng.integers(-(2**20), 2**20, (rows, n_ch)).astype(np.int32)
    q[:, 0] = np.arange(rows) - rows // 2  # every half-integer of the first channel
    q[:, 1] = np.arange(rows) * 2 - rows + 1
    q[:, 3] = np.linspace(-(2**30), 2**30, rows).astype(np.int32)  # both rails
    q[0] = 0
    return q, bias_q, m, s


@pytest.mark.parametrize("act,out_zp,out_scale", [(0, 0, 0.05), (0, -7, 0.05), (1, -3, 0.05),
                                                   (2, 5, 0.1)])
def test_requant_fixed_matches_jax(act, out_zp, out_scale, monkeypatch):
    rng = np.random.default_rng(11 + act)
    q, bias_q, m, s = _requant_case(rng)
    tact, jact = list(FusedActivation)[act], list(JAct)[act]
    got = tfp.requant_fixed(torch.from_numpy(q), torch.from_numpy(bias_q)[None, :], m, s,
                            out_zp, tact, out_scale).numpy()

    def run():
        fn = jax.jit(lambda qq, bb: jfp.requant_fixed(qq, bb, jnp.asarray(m), jnp.asarray(s),
                                                      out_zp, jact, out_scale))
        return np.asarray(fn(jnp.asarray(q), jnp.asarray(bias_q)[None, :]))

    want = run()
    assert got.dtype == want.dtype == np.int8
    lo, hi = activation_bounds(tact, out_scale, out_zp)
    sens = exp2_sensitive(q, bias_q[None, :], m, s, out_zp, lo, hi)
    assert np.array_equal(got[~sens], want[~sens])
    with monkeypatch.context() as mp:
        mp.setattr(jnp, "exp2", exact_exp2)
        exact = run()
    assert np.array_equal(got, exact), f"{int(sens.sum())} exp2-sensitive elements"
    # the ties of the first two channels round half away from zero
    p = (q[:, 0].astype(np.int64) + 1) / 2
    want0 = np.clip(np.sign(p) * np.floor(np.abs(p) + 0.5) + out_zp, lo, hi)
    assert np.array_equal(got[:, 0], want0.astype(np.int8))


def _forwards(name, x, monkeypatch, exact: bool):
    jg, tg, _ = _mac_layers(name)
    jparams = j_init_params(jg)
    got = build_fixed_forward(tg)(params_from_numpy(jparams, "cpu"), torch.from_numpy(x)).numpy()
    with monkeypatch.context() as mp:
        if exact:
            mp.setattr(jnp, "exp2", exact_exp2)
        want = np.asarray(jax.jit(j_build_fixed_forward(jg))(jparams, jnp.asarray(x)))
    return got, want


@pytest.mark.parametrize("name", MODELS)
def test_fixed_forward_matches_jax_with_exact_powers(name, monkeypatch):
    """Seed and shapes of ``tests/test_fixedpoint.py``."""
    x = np.random.default_rng(5).integers(-128, 128, SHAPES[name], dtype=np.int8)
    got, want = _forwards(name, x, monkeypatch, exact=True)
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", MODELS)
def test_fixed_forward_matches_jax(name, monkeypatch):
    """The JAX function as it is, at a seed where its ``jnp.exp2`` moves no
    element (checked: it equals the run with exact powers)."""
    x = np.random.default_rng(6).integers(-128, 128, SHAPES[name], dtype=np.int8)
    got, want = _forwards(name, x, monkeypatch, exact=False)
    _, want_exact = _forwards(name, x, monkeypatch, exact=True)
    assert np.array_equal(want, want_exact), f"{name}: pick another seed"
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", MODELS)
def test_fixed_layers_within_1_lsb_of_xla(name):
    """Each MAC layer's fixed requant within 1 output LSB of the port's
    ``xla`` layer on the same input (along the ``xla`` chain); the whole
    forward within 2 (person_detect reaches 2 at this seed)."""
    jg, tg, _ = _mac_layers(name)
    params = params_from_numpy(j_init_params(jg), "cpu")
    x0 = torch.from_numpy(np.random.default_rng(5).integers(-128, 128, SHAPES[name],
                                                            dtype=np.int8))
    x, worst = x0, {}
    for layer in tg.layers:
        y = apply_layer(layer, params, x, "xla")
        if isinstance(layer, MAC):
            one = build_fixed_forward(dataclasses.replace(tg, layers=[layer]))
            d = (one(params, x).to(torch.int32) - y.to(torch.int32)).abs().max().item()
            worst[layer.index] = d
        x = y
    assert worst and max(worst.values()) <= 1, worst
    full = build_fixed_forward(tg)(params, x0).to(torch.int32)
    assert (full - x.to(torch.int32)).abs().max().item() <= 2


def test_fixed_forward_refuses_uint8(tmp_path):
    from microflow_tpu.models import synth

    g = tparse(synth.write(str(tmp_path / "u8.tflite"), synth.uint8_mlp()))
    with pytest.raises(NotImplementedError, match="int8 graphs only"):
        build_fixed_forward(g)


def test_fixed_forward_keeps_non_mac_layers_exact():
    """Softmax and the pool stay on the exact float path: a graph of only
    those layers gives ``xla``'s bits."""
    tg = tparse(model_path("person_detect"))
    params = params_from_numpy(j_init_params(jparse(model_path("person_detect"),
                                                    frontend="python")), "cpu")
    tail = [layer for layer in tg.layers if not isinstance(layer, MAC)]
    x = torch.from_numpy(np.random.default_rng(2).integers(-128, 128, (3, 3, 3, 2),
                                                           dtype=np.int8))
    y = x
    for layer in tail:
        y = apply_layer(layer, params, y, "xla")
    got = build_fixed_forward(dataclasses.replace(tg, layers=tail))(params, x)
    assert torch.equal(got, y)
