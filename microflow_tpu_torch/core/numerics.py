"""Exact float/integer numeric primitives shared by every op and kernel.

The engine promises bit-parity (or <=1 LSB for softmax) with the MicroFlow
Rust reference, whose scalar math is:

* ``libm::roundf``  -- round half AWAY from zero (reference
  ``src/quantize.rs:27``),
* Rust ``as`` casts from f32 to i8/u8/i32 -- saturating,
* plain IEEE-754 f32 adds and multiplies, one rounding each, in the
  reference's association order.

``torch.round`` rounds half to even, and ``floor(y + 0.5)`` is wrong at
``y = 0.5 - 2**-25`` (the f32 add rounds up to 1), so ``round_away`` is
built from ``trunc``.  Every f32 constant that enters an op is a tensor on
the operand's device: PyTorch's CUDA division by a host scalar multiplies
by its reciprocal, which is not the reference's division.

Copies between the host and a device go through ``const_f32``,
``const_int``, ``as_device`` and ``read_host``, which count each one that
crosses as ``mft.host_waits`` (``utils/trace.py``): a copy from pageable
host memory or a read of a device value makes the host wait on the device.
A constant (a host value given to ``const_f32`` or ``const_int``) is
copied once a device: later calls with the same bits get the same
resident tensor, which no caller writes, so that a step makes no copy
from the host and a CUDA graph can capture it.  ``as_device`` copies
every time: an input stays the caller's.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..utils import trace

# Integer range table for saturating casts.
_INT_INFO = {
    torch.int8: (-128, 127),
    torch.uint8: (0, 255),
    torch.int16: (-32768, 32767),
    torch.int32: (-(2**31), 2**31 - 1),
}

_NP_TO_TORCH = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
}


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype (or type) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


def round_away(y: torch.Tensor) -> torch.Tensor:
    """f32 round-half-away-from-zero, bit-matching ``libm::roundf``
    (signed zeros included).

    ``y - trunc(y)`` is exact in f32, so the tie test is exact too.
    """
    t = torch.trunc(y)
    return torch.where(torch.abs(y - t) >= 0.5, t + torch.sign(y), t)


def saturating_cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """Rust ``as`` float->int cast: clamp to the target range, then convert.

    The input is expected to hold integral values already (post-round).
    """
    dtype = torch_dtype(dtype)
    lo, hi = _INT_INFO[dtype]
    return torch.clamp(x, lo, hi).to(dtype)


def saturating_add_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """i32 saturating add (reference ``accumulate_gradient_4D``,
    ``src/update_layer.rs:289``): the exact sum in int64, clamped."""
    lo, hi = _INT_INFO[torch.int32]
    return torch.clamp(a.to(torch.int64) + b.to(torch.int64), lo, hi).to(torch.int32)


def saturating_sub_int(a: torch.Tensor, b) -> torch.Tensor:
    """Saturating subtract in ``a``'s own integer dtype (reference
    ``Saturating::saturating_sub`` on i8)."""
    lo, hi = _INT_INFO[a.dtype]
    wide = a.to(torch.int64) - b
    return torch.clamp(wide, lo, hi).to(a.dtype)


def sat_cast_nan0(x: torch.Tensor, dtype) -> torch.Tensor:
    """Rust ``as`` from f32 to an integer type: saturating, NaN -> 0, on
    integral values.  Clamped in float64, where both rails of int32 are
    exact: torch's own f32 -> int32 conversion of 2**31 gives INT_MIN on
    the CPU."""
    dtype = torch_dtype(dtype)
    lo, hi = _INT_INFO[dtype]
    y = torch.clamp(x.to(torch.float64), lo, hi)
    return torch.where(torch.isnan(y), 0.0, y).to(torch.int64).to(dtype)


def f32(x: torch.Tensor) -> torch.Tensor:
    """Explicit float32 conversion (mirrors ``f32::from_subset``)."""
    return x.to(torch.float32)


def _device_type(device) -> str:
    if isinstance(device, torch.device):
        return device.type
    if isinstance(device, str):
        return device.split(":", 1)[0]
    return torch.device(device).type


def _crossing(src, dst) -> None:
    """Count a copy from ``src`` to ``dst`` as a host wait where one of the
    two is the host and the other is not."""
    if _device_type(src) != _device_type(dst):
        trace.count(trace.HOST_WAITS)


def _upload(value, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(value, dtype, device)`` of a host value: the one
    place a host value is copied to a device."""
    _crossing("cpu", device)
    return torch.as_tensor(value, dtype=dtype, device=device)


# Resident constants: (numpy dtype, shape, bytes, torch dtype, device) ->
# the tensor, the most recently used last.  Past RESIDENT_CAP the least
# recently used is dropped; a CUDA graph keeps those it captured
# (``pinned``), so that none is freed under it.
RESIDENT_CAP = 4096
_resident: OrderedDict = OrderedDict()
_resident_lock = threading.Lock()
_pins = threading.local()


def _constant(arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(arr, dtype, device)`` of a host constant, copied to
    ``device`` the first time its bits are asked for there."""
    device = torch.device(device)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype, device)
    with _resident_lock:
        t = _resident.get(key)
        if t is not None:
            _resident.move_to_end(key)
    if t is None:
        # a copy of the array: on the CPU as_tensor would share its memory,
        # and the caller may change it later
        t = _upload(np.array(arr), device, dtype)
        with _resident_lock:
            t = _resident.setdefault(key, t)
            while len(_resident) > RESIDENT_CAP:
                _resident.popitem(last=False)
    pins = getattr(_pins, "list", None)
    if pins is not None:
        pins.append(t)
    return t


@contextlib.contextmanager
def pinned():
    """Collect the resident constants that this thread is given inside, in
    a list: whatever holds the list (a captured CUDA graph) keeps them."""
    outer = getattr(_pins, "list", None)
    _pins.list = []
    try:
        yield _pins.list
    finally:
        _pins.list = outer


def const_f32(value, device) -> torch.Tensor:
    """An f32 constant (scalar or per-channel vector, host value or
    tensor) on ``device``; a host value is resident after its first use."""
    if torch.is_tensor(value):
        _crossing(value.device, device)
        return value.to(device=device, dtype=torch.float32)
    return _constant(np.asarray(value, np.float32), device)


def const_int(value, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(value, dtype, device)`` of an integer host constant
    (a scalar, list or numpy array), resident after its first use:
    ``const_f32``'s twin."""
    return _constant(np.asarray(value), device, dtype)


def as_device(value, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(value, dtype, device)`` of an input (a numpy
    array, host value or tensor), copied at every call."""
    if torch.is_tensor(value):
        _crossing(value.device, device)
        return torch.as_tensor(value, dtype=dtype, device=device)
    return _upload(value, device, dtype)


def read_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``: a device value read on the host (``int(read_host(t))``
    for a count or a bound)."""
    _crossing(t.device, "cpu")
    return t.cpu()


def broadcast_per_channel(values, n: int, dtype) -> np.ndarray:
    """Reference ``.get(i).unwrap_or(arr[0])`` as a static broadcast of a
    scalar or per-channel host value to ``n`` channels."""
    values = np.atleast_1d(np.asarray(values))
    return np.array([values[i] if i < len(values) else values[0] for i in range(n)], dtype)


# --- host-side (numpy) epilogue, to hold the kernels to their rounding -------


def np_round_away(y: np.ndarray) -> np.ndarray:
    """``round_away`` in numpy."""
    t = np.trunc(y)
    return t + np.sign(y) * (np.abs(y - t) >= 0.5)


def np_exact2(y: np.ndarray) -> np.ndarray:
    """The whole-network kernels' round, ``trunc(y + (y >= 0 ? 0.5 : -0.5))``
    in f32; not round-half-away at ``y = +-(0.5 - 2**-25)``."""
    y = np.asarray(y, np.float32)
    return np.trunc((y + np.where(y >= 0, np.float32(0.5), np.float32(-0.5))).astype(np.float32))


def np_epilogue(a, b, add) -> tuple[np.ndarray, np.ndarray]:
    """f32 ``add + a*b`` as a multiply then an add (the kernels' order) and
    as one fused multiply-add (emulated in float64, where the product of
    two f32 values is exact)."""
    a, b, add = (np.asarray(v, np.float32) for v in (a, b, add))
    sep = (add + (a * b).astype(np.float32)).astype(np.float32)
    fma = (add.astype(np.float64) + a.astype(np.float64) * b.astype(np.float64)).astype(np.float32)
    return sep, fma
