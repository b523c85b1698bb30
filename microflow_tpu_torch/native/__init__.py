"""The native (C++) front end: the TFLite parser and the constant fold,
bound with ctypes.

``tflite_parser.cpp`` walks the flatbuffer's vtables in C++ and returns
JSON metadata with the byte offset of every weight payload, which the
adapter (``frontend/native_backend.py``) maps without a copy; its
``mf_fold_*`` functions fold the requantization constants in the same f32
order as ``compiler/folding.py``.  It is the port's own copy of
``microflow_tpu/native/tflite_parser.cpp``: the same C ABI, with bounds
checks added and the subgraph's name in the metadata.

``g++`` builds it on first use, one call of about a second, into
``build/native/libmf_tflite_<hash>.so`` at the root of the checkout
(``.gitignore`` lists ``build/``), never beside the source.  The hash
covers the source and the flags, so a changed source is rebuilt and an
unchanged one is reused by every later process.  The library is written
under a name that carries the process and thread ids and then renamed
into place, so processes and threads that build at once never see half a
file.  Nothing is built at import.  Where ``g++`` is missing or fails,
``available()`` is False and the error is kept for the caller that asked
for the native front end by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC = os.path.join(_ROOT, "microflow_tpu_torch", "native", "tflite_parser.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def build(build_dir: str = BUILD_DIR) -> str:
    """Build the library into ``build_dir`` unless it is there already;
    returns its path.  Raises ``RuntimeError`` with the compiler's output if
    ``g++`` fails, ``OSError`` if it cannot be run."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(build_dir, f"libmf_tflite_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    out = subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"g++ exit {out.returncode}: {out.stderr}")
    os.replace(tmp, so)
    return so


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.mf_parse_tflite.restype = ctypes.c_int
    lib.mf_parse_tflite.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                                    ctypes.c_size_t]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
    lib.mf_fold_fc.restype = None
    lib.mf_fold_fc.argtypes = [
        ctypes.c_float, ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
        ctypes.c_float, ctypes.c_int64, ctypes.c_float,
        i32p, ctypes.c_int32, i8p, ctypes.c_int32,
        f32p, f32p, i32p, i32p,
    ]
    lib.mf_fold_conv.restype = None
    lib.mf_fold_conv.argtypes = [
        ctypes.c_float, ctypes.c_float,
        f32p, ctypes.c_int32, f32p, ctypes.c_int32, i64p, ctypes.c_int32,
        i32p, ctypes.c_int32, f32p, f32p,
    ]
    lib.mf_fold_avgpool.restype = None
    lib.mf_fold_avgpool.argtypes = [
        ctypes.c_float, ctypes.c_int32, ctypes.c_float, ctypes.c_int32, f32p, f32p,
    ]
    return lib


def _ensure_built() -> None:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return
        try:
            _lib = _load(build())
        except (OSError, RuntimeError) as e:  # no compiler, a failed build or load
            _build_error = str(e)


def available() -> bool:
    """Whether the library builds and loads (building it on first call)."""
    _ensure_built()
    return _lib is not None


def _library():
    _ensure_built()
    if _lib is None:
        raise RuntimeError(f"the native front end is unavailable: {_build_error}")
    return _lib


def parse_metadata(buf: bytes) -> dict:
    """Parse a ``.tflite`` buffer with the native parser -> metadata dict.
    Raises ``ValueError`` on bytes that are not a well-formed model."""
    lib = _library()
    cap = 1 << 20
    while True:
        out = ctypes.create_string_buffer(cap)
        rc = lib.mf_parse_tflite(buf, len(buf), out, cap)
        if rc == -1:
            raise ValueError("native parser: invalid TFLite model")
        if rc < -1:
            cap = (-rc - 2) + 16
            continue
        return json.loads(out.value.decode("utf-8"))


def fold_fc(in_scale, in_zp, w_scale, w_zp, bias_scale, bias_zp, out_scale,
            bias: np.ndarray, weights_kn: np.ndarray):
    """Native FC constant folding -> (c0 f32[N], c1 f32, c2 i32[N], c3 i32)."""
    lib = _library()
    bias = np.ascontiguousarray(bias, np.int32)
    w = np.ascontiguousarray(weights_kn, np.int8)
    k, n = w.shape
    if bias.ndim != 1 or len(bias) < n:  # the C function reads n entries
        raise ValueError(f"bias of shape {bias.shape} for {n} output channels")
    c0 = np.empty(n, np.float32)
    c1 = np.empty(1, np.float32)
    c2 = np.empty(n, np.int32)
    c3 = np.empty(1, np.int32)
    lib.mf_fold_fc(
        np.float32(in_scale), int(in_zp), np.float32(w_scale), int(w_zp),
        np.float32(bias_scale), int(bias_zp), np.float32(out_scale),
        bias, n, w, k, c0, c1, c2, c3,
    )
    return c0, np.float32(c1[0]), c2, int(c3[0])


def fold_conv(in_scale, out_scale, w_scales, bias_scales, bias_zps,
              bias: np.ndarray, num_filters: int):
    """Native conv/dwconv folding -> (c0 f32[F], c1 f32[n_wq])."""
    lib = _library()
    ws = np.ascontiguousarray(w_scales, np.float32)
    bs = np.ascontiguousarray(bias_scales, np.float32)
    bz = np.ascontiguousarray(bias_zps, np.int64)
    bias = np.ascontiguousarray(bias, np.int32)
    if bias.ndim != 1 or len(bias) < num_filters or not (len(bs) and len(bz)):
        raise ValueError(f"bias of shape {bias.shape} for {num_filters} filters, "
                         f"{len(bs)} bias scales, {len(bz)} bias zero points")
    c0 = np.empty(num_filters, np.float32)
    c1 = np.empty(len(ws), np.float32)
    lib.mf_fold_conv(
        np.float32(in_scale), np.float32(out_scale),
        ws, len(ws), bs, len(bs), bz, len(bz), bias, num_filters, c0, c1,
    )
    return c0, c1


def fold_avgpool(in_scale, in_zp, out_scale, out_zp):
    """Native avgpool folding -> (c0 f32, c1 f32)."""
    lib = _library()
    c0 = np.empty(1, np.float32)
    c1 = np.empty(1, np.float32)
    lib.mf_fold_avgpool(np.float32(in_scale), int(in_zp), np.float32(out_scale), int(out_zp),
                        c0, c1)
    return np.float32(c0[0]), np.float32(c1[0])
