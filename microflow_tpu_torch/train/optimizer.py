"""Integer SGD update family (reference R16, ``src/update_layer.rs``), as
``microflow_tpu.train.optimizer``.

Numeric fidelity notes (all replicated exactly):

* ``update_weights_2D``/``_4D`` round the step (`.round()` = half away
  from zero) before the saturating f32->int cast;
* ``update_weights_clip_norm_2D`` (the variant the train codegen actually
  emits) does NOT round: Rust's ``as`` float->int TRUNCATES toward zero;
  its norm uses *integer* division ``g / batch`` per element, squares in
  wrapping i32, and sums the squares as f32 values (here exactly, rounded
  once: the JAX package's f32 sum agrees while it stays below 2**24);
* weight subtraction is saturating in the weight dtype;
* every f32 expression keeps the reference's left-to-right order, each
  constant an f32 tensor on the operand's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.numerics import (
    const_f32,
    f32,
    read_host,
    round_away,
    sat_cast_nan0,
    saturating_add_i32,
    saturating_sub_int,
)

I32_MAX = 2**31 - 1


def _sat_cast_trunc(x: torch.Tensor, dtype) -> torch.Tensor:
    """Rust ``as`` from f32 to int: truncate toward zero, saturate, NaN->0."""
    return sat_cast_nan0(torch.trunc(x), dtype)


def _sat_cast_round(x: torch.Tensor, dtype) -> torch.Tensor:
    """`.round()` then ``as``: half-away round, saturate, NaN->0."""
    return sat_cast_nan0(round_away(x), dtype)


def update_weights_2d(weights, grad_i32, batch_size: int, lr: float):
    """Plain SGD (``update_layer.rs:13-27``)."""
    dev = weights.device
    step = const_f32(lr, dev) * f32(grad_i32) / const_f32(batch_size, dev)
    return saturating_sub_int(weights, _sat_cast_round(step, weights.dtype))


def update_weights_max_2d(weights, grad_i32, batch_size: int, lr: float):
    """Max-rescaled SGD (``update_layer.rs:69-94``)."""
    dev = weights.device
    mx = grad_i32.abs().max()
    scale = const_f32(127.0, dev) * const_f32(batch_size, dev) / f32(mx)
    step = const_f32(lr, dev) * f32(grad_i32) * scale / const_f32(batch_size, dev)
    return saturating_sub_int(weights, _sat_cast_trunc(step, weights.dtype))


def update_weights_clip_2d(weights, grad_i32, batch_size: int, lr: float):
    """Clip-at-127x-min SGD (``update_layer.rs:95-129``)."""
    dev = weights.device
    a = grad_i32.abs()
    min_val = torch.where(a > 0, a, torch.full_like(a, I32_MAX)).min()
    scale = const_f32(batch_size, dev) / f32(min_val)
    clip_value = f32(min_val) * const_f32(127.0, dev)
    g = f32(grad_i32)
    clipped = torch.where(g.abs() < clip_value, g, clip_value * torch.sign(g))
    step = const_f32(lr, dev) * clipped * scale / const_f32(batch_size, dev)
    return saturating_sub_int(weights, _sat_cast_trunc(step, weights.dtype))


def update_weights_clip_norm_2d(weights, grad_i32, batch_size: int, lr: float):
    """Norm-clipped SGD: THE variant the FC train codegen emits
    (``update_layer.rs:130-157``;
    ``microflow-train-macros/src/ops/fully_connected.rs:340``)."""
    return clip_norm_step(weights, grad_i32, clip_norm_squares(grad_i32, batch_size),
                          batch_size, lr)


def clip_norm_squares(grad_i32, batch_size: int) -> torch.Tensor:
    """The clip norm's sum of squares, exact, as a float64 scalar: the f32
    values of the wrapping i32 squares of ``g / B`` (Rust's i32 division,
    truncating toward zero).  Each is an integer below 2**31, so sums over
    slices of the matrix add up, exactly, to the whole's while below 2**53."""
    # Rust i32 division truncates toward zero, as sign * (|g| // B); |g|
    # wraps at INT_MIN, as jnp.abs does
    a = grad_i32.abs().to(torch.int64)
    per = (torch.sign(grad_i32).to(torch.int64) * (a // batch_size)).to(torch.int32)
    sq = (per.to(torch.int64) * per.to(torch.int64)).to(torch.int32)  # wrapping i32
    return f32(sq).to(torch.float64).sum()


def clip_norm_step(weights, grad_i32, squares: torch.Tensor, batch_size: int, lr: float):
    """The clip-norm update of ``weights`` (the whole matrix or rows of it)
    from the whole matrix's ``clip_norm_squares``, rounded to f32 once."""
    dev = weights.device
    norm = torch.sqrt(squares.to(torch.float32))
    scale = torch.where(norm > 127.0, const_f32(1024.0, dev) / norm, const_f32(1.0, dev))
    step = const_f32(lr, dev) * f32(grad_i32) * scale / const_f32(batch_size, dev)
    return saturating_sub_int(weights, _sat_cast_trunc(step, weights.dtype))


def _top_k_index(flat_abs: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries, the lowest index first among
    ties (``lax.top_k``'s order, and the reference's insertion sort's)."""
    n = flat_abs.numel()
    pos = torch.arange(n, device=flat_abs.device, dtype=torch.int64)
    key = flat_abs.to(torch.int64) * n + (n - 1 - pos)  # larger |g| first, then lower index
    return torch.topk(key, k, sorted=True).indices


def update_weights_perc_2d(weights, grad_i32, batch_size: int, lr: float, perc: int):
    """Top-``perc``-|g| update (``update_layer.rs:28-68``)."""
    dev = weights.device
    flat_abs = grad_i32.abs().reshape(-1)  # wraps at INT_MIN, as jnp.abs does
    idx = _top_k_index(flat_abs, perc)
    mx = flat_abs[idx[0]]
    scale = const_f32(127.0, dev) * const_f32(batch_size, dev) / f32(mx)
    g = f32(grad_i32.reshape(-1)[idx])
    step = const_f32(lr, dev) * g * scale / const_f32(batch_size, dev)
    w = weights.reshape(-1).clone()
    w[idx] = saturating_sub_int(w[idx], _sat_cast_trunc(step, weights.dtype))
    return w.reshape(weights.shape)


def update_weights_2d_float(weights_f32, grad_f32, batch_size: int, lr: float):
    """f32 update for the folded bias constants C0
    (``update_layer.rs:158-169``)."""
    dev = weights_f32.device
    return weights_f32 - const_f32(lr, dev) * grad_f32 / const_f32(batch_size, dev)


def update_weights_2d_from_float(weights, grad_f32, w_scale: float, batch_size: int, lr: float):
    """Plain SGD driven by a dequantized-domain f32 gradient (the JAX
    package's completion of the reference's "unquantized" twin
    experiment): the step, divided by the weight scale onto the int8 grid,
    with ``update_weights_2D``'s rounding and saturation."""
    dev = weights.device
    denom = const_f32(np.float32(batch_size) * np.float32(w_scale), dev)
    step = const_f32(lr, dev) * grad_f32 / denom
    return saturating_sub_int(weights, _sat_cast_round(step, weights.dtype))


# update_weights_4D shares update_weights_2D's elementwise math
update_weights_4d = update_weights_2d


def update_weights_perc_4d(weights, grad_i32, batch_size: int, lr: float, perc: int):
    """Top-``perc``-|g| update, 4D semantics (``update_layer.rs:215-260``).

    NOT the 2D math: the reference's 4D variant applies *plain rounded
    SGD* (``round(lr*g/batch)``, no 127/max rescale) restricted to the
    top-``perc`` elements by |gradient|, ties to the earlier-scanned
    element.

    Degenerate corner (fewer than ``perc`` elements with nonzero |g|): the
    reference's fixed-size insertion list keeps its default ``(0,
    (0,0,0,0))`` entries, and the final loop re-applies the saturating
    update at flat index 0 once per leftover slot, reading the REAL
    gradient there (``update_layer.rs:253-259``).  Same-sign saturating
    subtraction is monotone, so k extra applications equal one wide
    subtract of ``k * delta0``, clamped."""
    dev = weights.device
    flat_g = grad_i32.reshape(-1)
    idx = _top_k_index(flat_g.abs(), perc)
    step = const_f32(lr, dev) * f32(flat_g[idx]) / const_f32(batch_size, dev)
    w = weights.reshape(-1).clone()
    w[idx] = saturating_sub_int(w[idx], _sat_cast_round(step, weights.dtype))
    extra = max(perc - int(read_host((flat_g.abs() > 0).sum())), 0)
    if extra:
        step0 = const_f32(lr, dev) * f32(flat_g[0]) / const_f32(batch_size, dev)
        delta0 = _sat_cast_round(step0, weights.dtype).to(torch.int64)
        info = torch.iinfo(weights.dtype)
        w[0] = torch.clamp(w[0].to(torch.int64) - extra * delta0, info.min, info.max)
    return w.reshape(weights.shape)


def update_constants_fully_connected(weights, in_zp: int) -> torch.Tensor:
    """Re-fold C2 = in_zp * colsum(W), in wrapping i32, after a weight
    update (``update_layer.rs:199-214``)."""
    return refold_c2(weights.to(torch.int64).sum(0), in_zp)


def refold_c2(colsum_i64: torch.Tensor, in_zp: int) -> torch.Tensor:
    """C2 from W's exact int64 column sums (over all of W's rows)."""
    return (colsum_i64 * int(in_zp)).to(torch.int32)


def accumulate_gradient_2d(current, accum_i32):
    """Plain wrapping i32 accumulation (``update_layer.rs:261-271``)."""
    return (accum_i32.to(torch.int64) + current.to(torch.int64)).to(torch.int32)


def accumulate_gradient_4d(current, accum_i32):
    """Saturating i32 accumulation (``update_layer.rs:273-294``)."""
    return saturating_add_i32(accum_i32, current)


def fold_margin(batch: int) -> int:
    """The most a batch of per-sample int8 gradients moves an entry of the
    accumulator: 128 a sample (int8 reaches -128; the JAX package's fast
    fold counts 127, ``optimizer.py:209``)."""
    return 128 * batch


def fold_is_plain_sum(bound: int, batch: int) -> bool:
    """Whether the saturating fold of ``batch`` int8 gradients into an
    accumulator whose entries are within ``bound`` in magnitude can clamp
    at no step, so that it equals the plain sum."""
    return bound + fold_margin(batch) < 2**31


def plain_fold(dW_b, accum_i32):
    """``accum_i32`` plus the sum of the per-sample gradients [B, *W] over the
    batch, wrapped to i32: the fold where it cannot saturate."""
    return (accum_i32.to(torch.int64) + dW_b.to(torch.int64).sum(0)).to(torch.int32)


def accumulate_gradient_4d_fold(dW_b, accum_i32, bound: int | None = None):
    """Batch-order saturating fold of per-sample gradients [B, *W] into
    ``accum_i32``: the reference's per-sample ``accumulate_gradient_4D``
    calls (``update_layer.rs:273-294``, driven one sample at a time by
    ``examples/speech_train.rs:76-93``) over the sample axis.

    The serial fold is the semantics of record.  Where ``dW_b`` is int8
    and no prefix of the fold can reach a rail (``fold_is_plain_sum`` of
    ``bound``, a bound on the accumulator's entries the caller keeps on
    the host; ``None`` reads it from the tensor), the fold equals the
    plain sum, which is what runs then."""
    acc = accum_i32.to(torch.int32)
    if dW_b.dtype == torch.int8:
        if bound is None:
            bound = int(read_host(acc.to(torch.int64).abs().max())) if acc.numel() else 0
        if fold_is_plain_sum(bound, dW_b.shape[0]):
            return plain_fold(dW_b, acc)
    for i in range(dW_b.shape[0]):
        acc = saturating_add_i32(acc, dW_b[i])
    return acc
