"""Fixed-point requantization: (integer multiplier, right-shift) form.

The counterpart of ``microflow_tpu.core.fixedpoint``.  Integer runtimes
(TFLite Micro, CMSIS-NN) fold the requant scale ``C1`` into an integer
multiplier and a rounding right-shift:

    y = out_zp + rshift_round((q + bias_q) * M, S)
    C1 ~= M / 2**S,    bias_q = round(C0 / C1)   (the bias in acc scale)

The integer product ``(q + bias_q) * M`` is carried in float32, as the JAX
package carries it with x64 off (the port has no x64 switch): with 15-bit
multipliers it can reach ~2**43, past f32's 24-bit mantissa, so single
products round, by far less than half an output quantum away from ties
(``<= 1`` output LSB against the exact f32 recipe on every bundled model).

``2**S`` and ``2**(S-1)`` are exact powers of two, made on the host.  The
JAX package evaluates them with ``jnp.exp2``, which XLA's CPU backend
computes a few ulps off at some shifts (17, 21, 23, 25, 26, 27 among the
bundled models'); on the rare element whose rounding that moves, the port
gives the exact ``rshift_round``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .activation import activation_bounds

_MBITS = 15  # multiplier precision


def quantize_multiplier(c1: float) -> tuple[int, int]:
    """c1 -> (M, S) with c1 ~= M / 2**S and M in [2**14, 2**15)."""
    c1 = float(c1)
    if c1 == 0.0 or not math.isfinite(c1):
        return 0, 0
    frac, exp = math.frexp(c1)  # c1 = frac * 2**exp, frac in [0.5, 1)
    m = round(frac * (1 << _MBITS))
    if m == (1 << _MBITS):  # rounding overflowed into the next octave
        m >>= 1
        exp += 1
    return m, _MBITS - exp


def quantize_multipliers(c1_vec) -> tuple[np.ndarray, np.ndarray]:
    """Per channel: (M as f32, S as i32)."""
    pairs = [quantize_multiplier(c) for c in np.atleast_1d(c1_vec)]
    return (np.array([p[0] for p in pairs], np.float32),
            np.array([p[1] for p in pairs], np.int32))


def multiplier_scale(c1_vec) -> np.ndarray:
    """Per channel ``M * 2**-S`` as f32: the flat kernel's one-multiply
    form of the (M, S) pair (exact: a power-of-two scale of a 15-bit
    integer)."""
    m, s = quantize_multipliers(c1_vec)
    return (m.astype(np.float64) * np.exp2(-s.astype(np.float64))).astype(np.float32)


def requant_fixed(q: torch.Tensor, bias_q, m, shift, out_zp: int, activation,
                  out_scale: float) -> torch.Tensor:
    """Integer requant: ``out_zp + rshift_round((q + bias_q) * M, S)``,
    rounding half away from zero, saturated to int8 with the activation
    folded into the bounds.  ``q`` is an integer-valued tensor; ``bias_q``
    a tensor broadcasting against it; ``m`` and ``shift`` per-channel host
    values (``quantize_multipliers``)."""
    dev = q.device
    f = torch.float32
    shift = np.asarray(shift, np.int64)
    half = torch.from_numpy(np.exp2(shift - 1.0).astype(np.float32)).to(dev)
    div = torch.from_numpy(np.exp2(shift.astype(np.float64)).astype(np.float32)).to(dev)
    p = (q.to(f) + bias_q.to(f)) * torch.from_numpy(np.asarray(m, np.float32)).to(dev)
    mag = torch.floor((torch.abs(p) + half) / div)  # round half away from zero
    y = torch.sign(p) * mag + torch.tensor(float(out_zp), dtype=f, device=dev)
    lo, hi = activation_bounds(activation, out_scale, out_zp)
    return torch.clamp(y, lo, hi).to(torch.int8)


def derive_bias_q(c0, c1_vec) -> torch.Tensor:
    """The bias in accumulator scale: ``round(f32(C0) / f32(C1))``, half to
    even, on ``c0``'s device when it is a tensor."""
    c0 = torch.as_tensor(c0)
    c1 = torch.as_tensor(np.atleast_1d(np.asarray(c1_vec, np.float32)), device=c0.device)
    return torch.round(c0.to(torch.float32) / c1)
