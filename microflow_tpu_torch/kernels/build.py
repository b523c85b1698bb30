"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C entry point and no PyTorch headers,
so ``nvcc`` builds it in seconds into ``build/torch_ext/`` at the root of
the checkout (``.gitignore`` lists ``build/``), and ``ctypes`` loads it.
The library's file name carries a hash of its source, of every
``csrc/*.cuh`` header it includes, and of the flags, so a changed source
or shared header is rebuilt and an unchanged one is reused.  All sources
build in parallel, one ``nvcc`` each.  Nothing here runs at import time:
the CPU tests import this module on machines without ``nvcc``.

Threads and processes may build at once (a serving thread and its
caller, the test workers): each compiles to a temporary name that carries
its process and thread ids and renames the result into place, and
``library`` loads each kernel once a process, under a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_ROOT, "microflow_tpu_torch", "csrc")
BUILD_DIR = os.path.join(_ROOT, "build", "torch_ext")

# -fmad=false: the epilogues must round the multiply and the add
# separately (the kernels also spell them out with __fmul_rn/__fadd_rn).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C signature of each kernel's entry point: (symbol, argtypes).
SIGNATURES = {
    "qgemm": ("mf_qgemm", [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _F, _F, _I, _I, _I, _P]),
    "qdwconv": ("mf_qdwconv",
                [_P, _P, _P, _P, _P, _P] + [_I] * 14 + [_F, _F] + [_I] * 6 + [_P]),
    "flatpack": ("mf_flatpack", [_P, _P, _L, _P, _I, _I, _I, _I, _I, _I, _P]),
    "colfc": ("mf_colfc", [_P, _P, _L, _P, _I, _I, _I, _I, _P]),
    "megakernel": ("mf_megakernel", [_P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _P]),
    "packed": ("mf_packed", [_P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _P]),
    "qadd": ("mf_qadd", [_P, _P, _P, _L] + [_I] * 13 + [_P]),
    "qsoftmax": ("mf_qsoftmax", [_P, _P, _L, _I, _F, _F, _I, _P]),
    "qwgrad": ("mf_qwgrad", [_P, _P, _P, _P] + [_I] * 6 + [_P]),
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset); cannot build kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(path: str, seen: set) -> list[bytes]:
    """The bytes of ``path`` and, recursively, of every file it includes
    with ``#include "..."`` (resolved beside it), each once."""
    if path in seen:
        return []
    seen.add(path)
    with open(path, "rb") as f:
        text = f.read()
    out = [text]
    for inc in _INCLUDE.findall(text):
        out += _sources(os.path.join(os.path.dirname(path), inc.decode()), seen)
    return out


def _target(name: str) -> str:
    parts = _sources(os.path.join(CSRC, f"{name}.cu"), set())
    digest = hashlib.sha256(b"\0".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build_all(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Build every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns name -> library path; raises
    with the compiler's output if any build fails.  ``ptxas -v`` output
    (registers, shared memory, spills) goes to ``<library>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, so in targets.items():
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        with open(targets[n] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use; threads
    that ask at once wait for one build."""
    lib = _LIBS.get(name)
    if lib is not None:  # every launch after the first: no lock
        return lib
    with _LIBS_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all((name,))[name]
            lib = ctypes.CDLL(path)
            symbol, argtypes = SIGNATURES[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def launch(fn, device, *args) -> int:
    """``fn(*args, stream)``: a kernel's entry point called with the raw
    current stream of ``device`` (a CUDA ``torch.device``), that device
    made current where it is not.  Cheaper on the host than
    ``torch.cuda.device`` and ``torch.cuda.current_stream()``, which each
    call pays once a launch."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch._C._cuda_getDevice():
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaError_t`` code)."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")
