"""The port's native front end (``microflow_tpu_torch/native/``, the C++
parser and fold bound with ctypes) against its Python reader and numpy
fold, and against the JAX package's native ones: every field equal, bit
for bit, on the bundled models; garbage refused; the library built under
``build/native/`` and nowhere in either package."""

import ctypes
import os
import threading

import numpy as np
import pytest
from test_torch_frontend import assert_same

from microflow_tpu import native as jnative
from microflow_tpu.frontend import parse as jparse
from microflow_tpu_torch import native
from microflow_tpu_torch.compiler import folding
from microflow_tpu_torch.compiler.ir import QuantInfo
from microflow_tpu_torch.frontend import parse
from microflow_tpu_torch.models import model_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("sine", "speech", "person_detect")
CONSTANTS = ("c0", "c1", "c2", "c3")


@pytest.fixture(scope="module")
def built():
    assert native.available(), native._build_error
    assert jnative.available()


def graph_fields(g) -> dict:
    """Every field of a parsed graph but its name and the port's
    ``wiring``, which a chain graph leaves None (the JAX package's graphs
    have no such field: it has no ADD)."""
    assert getattr(g, "wiring", None) is None
    return {k: v for k, v in vars(g).items() if k not in ("name", "wiring")}


@pytest.mark.parametrize("name", MODELS)
def test_native_parse_matches_python(built, name):
    """Every field, the subgraph's name included, bit for bit."""
    assert_same(parse(model_path(name), frontend="native"),
                parse(model_path(name), frontend="python"))


@pytest.mark.parametrize("name", MODELS)
def test_native_parse_matches_jax_native(built, name):
    """Every field but the name, which the JAX adapter drops (it names
    every graph "model"; the port's keeps the file's, as both Python
    readers do)."""
    got = graph_fields(parse(model_path(name), frontend="native"))
    want = graph_fields(jparse(model_path(name), frontend="native"))
    assert got.keys() == want.keys()
    for key in got:
        assert_same(want[key], got[key], key)


@pytest.mark.parametrize("name", MODELS)
def test_default_frontend_is_native(built, name, monkeypatch):
    from microflow_tpu_torch.frontend import native_backend

    loaded = []
    orig = native_backend.load_model
    monkeypatch.setattr(native_backend, "load_model", lambda p: loaded.append(p) or orig(p))
    assert_same(parse(model_path(name)), parse(model_path(name), frontend="python"))
    assert loaded == [model_path(name)]


def same(*values) -> bool:
    """Equal bytes and dtypes."""
    arrays = [np.asarray(v) for v in values]
    return all(a.dtype == arrays[0].dtype and a.tobytes() == arrays[0].tobytes()
               for a in arrays)


@pytest.mark.parametrize("name", MODELS)
def test_native_fold_matches_numpy_and_jax(built, name, monkeypatch):
    """The constants of every layer: the port's native fold, its numpy
    fold and the JAX package's native fold, bit for bit."""
    g_native = parse(model_path(name), frontend="python")
    g_jax = jparse(model_path(name), frontend="native")
    monkeypatch.setattr(folding, "_native", lambda: None)
    g_numpy = parse(model_path(name), frontend="python")
    n = 0
    for ln, lp, lj in zip(g_native.layers, g_numpy.layers, g_jax.layers, strict=True):
        for attr in CONSTANTS:
            if hasattr(ln, attr):
                assert same(*(getattr(x, attr) for x in (ln, lp, lj))), (name, ln.index, attr)
                n += 1
    assert n > 0


def test_native_fold_random_cases(built, monkeypatch):
    """The three folds on random quantization parameters (numpy seed),
    per-tensor and per-channel: the port's native fold equals its numpy
    fold and the JAX native fold."""
    rng = np.random.default_rng(7)

    def q(n=1):
        return QuantInfo(scale=rng.uniform(1e-4, 0.5, n).astype(np.float32),
                         zero_point=rng.integers(-128, 128, n).astype(np.int64))

    cases = []
    for _ in range(40):
        k, n = (int(v) for v in rng.integers(1, 300, 2))
        w = rng.integers(-128, 128, (k, n), dtype=np.int8)
        bias = rng.integers(-2**20, 2**20, n).astype(np.int32)
        per = [int(rng.choice([1, n])) for _ in range(3)]  # weight scales, bias scales, bias zps
        w_q = QuantInfo(scale=q(per[0]).scale, zero_point=q().zero_point)
        b_q = QuantInfo(scale=q(per[1]).scale, zero_point=q(per[2]).zero_point)
        cases.append((q(), w_q, b_q, q(), bias, w))
    got = [(native.fold_fc(i.scale0, i.zp0, wq.scale0, wq.zp0, b.scale0, b.zp0, o.scale0, bias,
                           w),
            native.fold_conv(i.scale0, o.scale0, wq.scale, b.scale, b.zero_point, bias,
                             w.shape[1]),
            native.fold_avgpool(i.scale0, i.zp0, o.scale0, o.zp0))
           for i, wq, b, o, bias, w in cases]
    want = [(jnative.fold_fc(i.scale0, i.zp0, wq.scale0, wq.zp0, b.scale0, b.zp0, o.scale0, bias,
                             w),
             jnative.fold_conv(i.scale0, o.scale0, wq.scale, b.scale, b.zero_point, bias,
                               w.shape[1]),
             jnative.fold_avgpool(i.scale0, i.zp0, o.scale0, o.zp0))
            for i, wq, b, o, bias, w in cases]
    monkeypatch.setattr(folding, "_native", lambda: None)
    ref = [(folding.preprocess_fully_connected(i, wq, bias, b, o, w),
            folding.preprocess_conv_2d(i, wq, bias, b, o, w.shape[1]),
            folding.preprocess_average_pool_2d(i, o))
           for i, wq, b, o, bias, w in cases]
    for c, (g, j, r) in enumerate(zip(got, want, ref)):
        for fold, (a, b, e) in enumerate(zip(g, j, r)):
            for part in range(len(a)):
                assert same(a[part], b[part], e[part]), (c, fold, part)


def test_native_fold_refuses_a_short_bias(built):
    """The C functions read one bias a channel: a shorter one is refused
    before the call."""
    with pytest.raises(ValueError, match="bias"):
        native.fold_fc(0.1, 0, 0.1, 0, 0.01, 0, 0.2, np.zeros(3, np.int32),
                       np.zeros((2, 4), np.int8))
    with pytest.raises(ValueError, match="bias"):
        native.fold_conv(0.1, 0.2, np.ones(4, np.float32), np.ones(1, np.float32),
                         np.zeros(1, np.int64), np.zeros(3, np.int32), 4)


def test_native_rejects_garbage(built, tmp_path):
    with pytest.raises(ValueError):
        native.parse_metadata(b"\x00" * 64)
    path = str(tmp_path / "garbage.tflite")
    with open(path, "wb") as f:
        f.write(b"\x10\x00\x00\x00TFL3" + bytes(range(256)) * 4)
    with pytest.raises(ValueError):
        parse(path, frontend="native")


def test_native_survives_truncated_and_corrupt_models(built):
    """Cut and corrupted copies of person_detect (numpy seed) are refused
    with ``ValueError`` or parsed; no read leaves the buffer."""
    with open(model_path("person_detect"), "rb") as f:
        buf = f.read()
    rng = np.random.default_rng(11)
    refused = 0
    for i in range(400):
        b = bytearray(buf[: int(rng.integers(8, len(buf)))] if i % 2 else buf)
        for pos in rng.integers(0, 2048, 0 if i % 2 else int(rng.integers(1, 16))):
            b[pos] = int(rng.integers(0, 256))
        try:
            native.parse_metadata(bytes(b))
        except ValueError:
            refused += 1
    assert refused > 0


def test_unknown_frontend_raises():
    with pytest.raises(ValueError, match="unknown frontend"):
        parse(model_path("sine"), frontend="bogus")


def test_without_the_library_native_raises_and_auto_reads_python(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", "g++: not found")
    assert not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+: not found"):
        parse(model_path("speech"), frontend="native")
    assert_same(parse(model_path("speech")), parse(model_path("speech"), frontend="python"))


def tree(*dirs) -> set:
    """Every file under ``dirs`` but the compiled bytecode, and but the JAX
    package's own ``native/libmf_tflite.so``, which the JAX package's build
    writes beside its source (other test processes may write it at any
    time)."""
    jax_lib = os.path.join(ROOT, "microflow_tpu", "native", "libmf_tflite.so")
    out = set()
    for d in dirs:
        for root, subdirs, files in os.walk(d):
            subdirs[:] = [s for s in subdirs if s != "__pycache__"]
            out |= {os.path.join(root, f) for f in files} - {jax_lib}
    return out


def test_library_builds_under_build_native_and_not_in_the_packages(built, tmp_path):
    assert native.build() == native._lib._name
    assert os.path.dirname(native._lib._name) == os.path.join(ROOT, "build", "native")
    packages = [os.path.join(ROOT, "microflow_tpu_torch"), os.path.join(ROOT, "microflow_tpu")]
    before = tree(*packages)
    out = tmp_path / "native"
    path = native.build(str(out))
    assert tree(*packages) == before
    assert not [p for p in tree(*packages) if "libmf_tflite_" in p]
    assert os.listdir(out) == [os.path.basename(path)]
    assert os.path.basename(path).startswith("libmf_tflite_") and path.endswith(".so")
    ctypes.CDLL(path).mf_parse_tflite  # noqa: B018 (the symbol is there)


def test_two_threads_building_at_once_leave_one_library(built, tmp_path):
    """Each build writes its own temporary name (process and thread ids)
    and renames it into place: both threads get the same whole library."""
    out = str(tmp_path / "native")
    barrier = threading.Barrier(2)
    paths, errors = [], []

    def run():
        try:
            barrier.wait(timeout=30)
            paths.append(native.build(out))
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(paths) == 2 and paths[0] == paths[1]
    assert os.listdir(out) == [os.path.basename(paths[0])]
    ctypes.CDLL(paths[0]).mf_parse_tflite  # noqa: B018
