"""The port's training arithmetic (``microflow_tpu_torch/core/numerics.py``'s
saturating ops, ``train/losses.py``, ``train/optimizer.py``) against the JAX
package's, on seeded numpy arrays, bit for bit: the i32 rails (INT_MIN,
INT_MAX), 0/0 -> NaN -> 0, and batch sizes 1, 3 and 7.  The JAX functions
run eagerly, op by op, which is the reference's f32 order (a jitted XLA
program may fold ``lr / B`` into one constant, ``test_torch_trainer.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microflow_tpu.core import numerics as jnum
from microflow_tpu.train import losses as jlosses
from microflow_tpu.train import optimizer as jopt
from microflow_tpu_torch.core import numerics as tnum
from microflow_tpu_torch.train import losses as tlosses
from microflow_tpu_torch.train import optimizer as topt

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
RAILS = np.array([I32_MIN, I32_MIN + 1, -1, 0, 1, I32_MAX - 1, I32_MAX], np.int32)


def t(a):
    return torch.from_numpy(np.array(a))


def same(port, ref):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    assert port.shape == ref.shape
    assert port.tobytes() == ref.tobytes(), np.flatnonzero(port != ref)[:10]


def i32_grads(rng, shape, scale):
    """i32 gradients: a normal draw at ``scale``, zeros, and the rails."""
    g = np.clip(rng.normal(0, scale, shape), I32_MIN, I32_MAX).astype(np.int32).reshape(-1)
    g[rng.random(g.size) < 0.2] = 0
    g[:len(RAILS)] = RAILS[:g.size]
    return g.reshape(shape)


# --- saturating ops ----------------------------------------------------------


def test_saturating_add_i32_at_the_rails():
    a, b = np.meshgrid(RAILS, RAILS)
    rng = np.random.default_rng(0)
    a = np.concatenate([a.ravel(), rng.integers(I32_MIN, I32_MAX, 5000, dtype=np.int32)])
    b = np.concatenate([b.ravel(), rng.integers(I32_MIN, I32_MAX, 5000, dtype=np.int32)])
    same(tnum.saturating_add_i32(t(a), t(b)), jnum.saturating_add_i32(jnp.asarray(a),
                                                                       jnp.asarray(b)))


@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
def test_saturating_sub_int(dtype):
    info = np.iinfo(dtype)
    v = np.arange(info.min, info.max + 1, dtype=dtype)
    a, b = (x.ravel() for x in np.meshgrid(v, v))
    same(tnum.saturating_sub_int(t(a), t(b)), jnum.saturating_sub_int(jnp.asarray(a),
                                                                       jnp.asarray(b)))


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_sat_cast_nan0_saturates_and_zeroes_nan(dtype):
    """NaN (what 0/0 gives) -> 0; +-inf and both f32 neighbours of the
    i32 rails saturate (torch's own f32 -> int32 conversion gives INT_MIN
    for 2**31 on the CPU), as XLA's conversion in the JAX package does."""
    x = np.array([np.nan, np.inf, -np.inf, 2.0**31, -(2.0**31), 2.0**31 - 128, 3e9, -3e9,
                  127.0, 128.0, -128.0, -129.0, 0.0], np.float32)
    from microflow_tpu.train.gradients import _sat_cast_nan0 as j_cast

    jd = {torch.int8: jnp.int8, torch.int32: jnp.int32}[dtype]
    same(tnum.sat_cast_nan0(t(x), dtype), j_cast(jnp.asarray(x), jd))


# --- losses ------------------------------------------------------------------


def test_mse_grad_and_loss():
    rng = np.random.default_rng(1)
    p = rng.integers(-128, 128, (7, 3), dtype=np.int8)
    g = rng.integers(-128, 128, (7, 3), dtype=np.int8)
    same(tlosses.mse_grad(t(p), t(g)), jlosses.mse_grad(jnp.asarray(p), jnp.asarray(g)))
    want = np.asarray(jlosses.mse_loss(jnp.asarray(p), jnp.asarray(g), 0.0235))
    got = tlosses.mse_loss(t(p), t(g), 0.0235).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_crossentropy_grad_and_loss(n):
    """The quantized softmax minus the label, as the JAX package's, on
    person_detect's (2) and speech's (4) widths: bit-equal (the softmax's
    sum is order-sensitive only past f32 ties these inputs do not meet)."""
    rng = np.random.default_rng(n)
    logits = rng.integers(-128, 128, (64, n), dtype=np.int8)
    label = rng.integers(-128, 128, (64, n), dtype=np.int8)
    args = (1 / 256.0, -128)
    same(tlosses.crossentropy_grad(t(logits), *args, t(label), in_scale=0.0625),
         jlosses.crossentropy_grad(jnp.asarray(logits), *args, jnp.asarray(label),
                                   in_scale=0.0625))
    want = np.asarray(jlosses.cross_entropy_loss(jnp.asarray(logits), *args,
                                                 jnp.asarray(label), in_scale=0.0625))
    got = tlosses.cross_entropy_loss(t(logits), *args, t(label), in_scale=0.0625).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


# --- optimizer ---------------------------------------------------------------

RULES = ["2d", "max_2d", "clip_2d", "clip_norm_2d", "4d"]


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("batch", [1, 3, 7])
@pytest.mark.parametrize("scale", [40.0, 3e4, 3e8])
def test_update_rules_match_jax(rule, batch, scale):
    """Each rule at the i32 rails (every gradient holds INT_MIN and
    INT_MAX), on small, large and wrapping magnitudes, and on an all-zero
    gradient."""
    rng = np.random.default_rng(int(scale) + batch)
    shape = (5, 3, 3, 4) if rule == "4d" else (37, 11)
    w = rng.integers(-128, 128, shape, dtype=np.int8)
    g = i32_grads(rng, shape, scale)
    zero = np.zeros(shape, np.int32)  # 0/0 -> NaN -> 0 in max_2d
    for lr in (0.01, 0.37):
        for grad in (g, zero):
            got = getattr(topt, f"update_weights_{rule}")(t(w), t(grad), batch, lr)
            same(got, getattr(jopt, f"update_weights_{rule}")(jnp.asarray(w),
                                                              jnp.asarray(grad), batch, lr))


def test_clip_norm_sum_of_squares_past_2_24():
    """The clip-norm rule sums squares that pass 2**24 (f32 adds round):
    the port sums them exactly and rounds once; the updated weights equal
    the JAX package's on these seeds."""
    for seed in range(6):
        rng = np.random.default_rng(seed)
        w = rng.integers(-128, 128, (64, 33), dtype=np.int8)
        g = rng.integers(-2**20, 2**20, (64, 33)).astype(np.int32)
        sq = (g.astype(np.int64) // 3) ** 2
        assert sq.sum() > 2**24
        same(topt.update_weights_clip_norm_2d(t(w), t(g), 3, 0.05),
             jopt.update_weights_clip_norm_2d(jnp.asarray(w), jnp.asarray(g), 3, 0.05))


@pytest.mark.parametrize("rule", ["perc_2d", "perc_4d"])
@pytest.mark.parametrize("perc", [1, 5, 40])
def test_perc_rules_match_jax(rule, perc):
    """Top-|g| rules, ties to the lower flat index (the gradients repeat
    values), and perc_4d's leftover slots (perc 40 > the 30 nonzeros)."""
    rng = np.random.default_rng(perc)
    shape = (4, 3, 3, 2) if rule == "perc_4d" else (8, 9)
    w = rng.integers(-128, 128, shape, dtype=np.int8)
    g = np.zeros(shape, np.int32).reshape(-1)
    g[rng.choice(g.size, 30, replace=False)] = rng.choice([-900, -7, 7, 30, 900, I32_MAX], 30)
    g = g.reshape(shape)
    for batch in (1, 3, 7):
        same(getattr(topt, f"update_weights_{rule}")(t(w), t(g), batch, 0.3, perc),
             getattr(jopt, f"update_weights_{rule}")(jnp.asarray(w), jnp.asarray(g), batch,
                                                     0.3, perc))


@pytest.mark.parametrize("batch", [1, 3, 7])
def test_float_updates_match_jax(batch):
    rng = np.random.default_rng(batch)
    c0 = rng.normal(0, 50, 33).astype(np.float32)
    gf = rng.normal(0, 1e3, 33).astype(np.float32)
    same(topt.update_weights_2d_float(t(c0), t(gf), batch, 0.05),
         jopt.update_weights_2d_float(jnp.asarray(c0), jnp.asarray(gf), batch, 0.05))
    w = rng.integers(-128, 128, (33, 5), dtype=np.int8)
    gw = rng.normal(0, 3.0, (33, 5)).astype(np.float32)
    gw[0, :3] = [np.inf, -np.inf, 0.0]
    same(topt.update_weights_2d_from_float(t(w), t(gw), 0.0123, batch, 0.05),
         jopt.update_weights_2d_from_float(jnp.asarray(w), jnp.asarray(gw), 0.0123, batch,
                                           0.05))


def test_update_constants_and_accumulate_2d_wrap():
    rng = np.random.default_rng(5)
    w = rng.integers(-128, 128, (4000, 4), dtype=np.int8)
    for zp in (-128, 0, 77):
        same(topt.update_constants_fully_connected(t(w), zp),
             jopt.update_constants_fully_connected(jnp.asarray(w), zp))
    acc = i32_grads(rng, (7, 9), 2e9)
    cur = i32_grads(rng, (7, 9), 2e9)
    same(topt.accumulate_gradient_2d(t(cur), t(acc)),
         jopt.accumulate_gradient_2d(jnp.asarray(cur), jnp.asarray(acc)))
    same(topt.accumulate_gradient_4d(t(cur), t(acc)),
         jopt.accumulate_gradient_4d(jnp.asarray(cur), jnp.asarray(acc)))


# --- the batch-order saturating fold ----------------------------------------


def serial_fold_jax(dW_b, acc):
    """JAX's fold given an i32 ``dW_b``: its serial branch
    (``optimizer.py:200-205``), the semantics of record."""
    return jopt.accumulate_gradient_4d_fold(jnp.asarray(dW_b, jnp.int32), jnp.asarray(acc))


@pytest.mark.parametrize("batch", [1, 3, 7])
def test_fold_matches_the_serial_fold_at_the_rails(batch):
    rng = np.random.default_rng(batch)
    dW_b = rng.integers(-128, 128, (batch, 5, 3), dtype=np.int8)
    dW_b[:, 0] = -128
    dW_b[:, 1] = 127
    acc = rng.integers(I32_MIN, I32_MAX, (5, 3), dtype=np.int32)
    acc[0] = [I32_MIN, I32_MIN + 128 * batch - 1, I32_MIN + 128 * batch]
    acc[1] = [I32_MAX, I32_MAX - 127 * batch, I32_MAX - 128 * batch]
    acc[2] = 0
    want = serial_fold_jax(dW_b, acc)
    for bound in (None, 2**31):  # read from the tensor; the host bound at the rail
        same(topt.accumulate_gradient_4d_fold(t(dW_b), t(acc), bound), want)
    # far from the rails the plain sum runs and gives the same bits
    small = rng.integers(-5000, 5000, (5, 3)).astype(np.int32)
    for bound in (None, 5000):
        same(topt.accumulate_gradient_4d_fold(t(dW_b), t(small), bound),
             serial_fold_jax(dW_b, small))
    # an i32 dW_b folds serially whatever the bound
    same(topt.accumulate_gradient_4d_fold(t(dW_b.astype(np.int32)), t(acc), 0), want)


def test_fold_margin_counts_minus_128():
    """A -128 case that a 127*B margin misjudges: two samples of -128 on an
    accumulator at -2**31 + 254.  The serial fold clamps at INT_MIN; the
    JAX package's int8 fast path (margin 127*B = 254 admits it) wraps to
    2**31 - 2; the port's margin of 128*B sends it to the serial fold."""
    dW_b = np.full((2, 1), -128, np.int8)
    acc = np.array([I32_MIN + 254], np.int32)
    want = serial_fold_jax(dW_b, acc)
    assert np.asarray(want).tolist() == [I32_MIN]
    jax_fast = np.asarray(jopt.accumulate_gradient_4d_fold(jnp.asarray(dW_b), jnp.asarray(acc)))
    assert jax_fast.tolist() == [I32_MAX - 1]
    bound = 2**31 - 254  # |acc|
    assert not topt.fold_is_plain_sum(bound, 2) and topt.fold_is_plain_sum(bound, 1)
    for bound in (None, bound):
        same(topt.accumulate_gradient_4d_fold(t(dW_b), t(acc), bound), want)
