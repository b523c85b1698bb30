"""The port's ``utils/`` (cost model, cosine similarity, checkpoints, the
layer table, the expansion dump, the throughput timer) and ``samples.py``
against the JAX package's, on the CPU."""

import os
import struct

import jax
import numpy as np
import pytest
import torch

from microflow_tpu import samples as jsamples
from microflow_tpu.frontend import parse as jparse
from microflow_tpu.models import synth as jsynth
from microflow_tpu.utils import checkpoint as jcheckpoint
from microflow_tpu.utils import flops as jflops
from microflow_tpu.utils import profiler as jprofiler
from microflow_tpu.utils.cosine import cosine_similarity as jcosine
from microflow_tpu_torch import compile_tflite
from microflow_tpu_torch import models as tmodels
from microflow_tpu_torch import samples as tsamples
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.models import model_path
from microflow_tpu_torch.utils import (
    activation_bytes_per_inference,
    cosine_similarity,
    dump_expansion,
    layer_table,
    load_params,
    macs_per_inference,
    save_params,
    time_predict,
    weight_bytes,
)

BUNDLED = ("sine", "speech", "person_detect")
SYNTH = ("lenet", "full_ops", "flat_conv", "uint8_mlp", "per_channel_dw")


@pytest.fixture(scope="module")
def graph_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("graphs")
    paths = {name: model_path(name) for name in BUNDLED}
    for gen in SYNTH:
        paths[gen] = jsynth.write(str(d / f"{gen}.tflite"), getattr(jsynth, gen)())
    return paths


@pytest.mark.parametrize("name", BUNDLED + SYNTH)
def test_cost_model_and_layer_table_equal_jax(graph_paths, name):
    tg, jg = tparse(graph_paths[name]), jparse(graph_paths[name], frontend="python")
    for port, ref in ((macs_per_inference, jflops.macs_per_inference),
                      (activation_bytes_per_inference, jflops.activation_bytes_per_inference),
                      (weight_bytes, jflops.weight_bytes)):
        assert port(tg) == int(ref(jg)), port.__name__
    assert layer_table(tg) == jprofiler.layer_table(jg)


@pytest.mark.parametrize("shape", [(5, 7), (3, 4, 4, 2), (1, 1960)])
def test_cosine_similarity_within_1e_6_of_jax(shape):
    rng = np.random.default_rng(len(shape))
    a = rng.integers(-128, 128, shape).astype(np.int8)
    b = (a.astype(np.float32) * rng.uniform(0.5, 1.5, shape)).astype(np.float32)
    got = cosine_similarity(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jcosine(a, b))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def assert_params_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for layer, arrays in a.items():
        assert arrays.keys() == b[layer].keys(), layer
        for k, v in arrays.items():
            v, w = np.asarray(v), np.asarray(b[layer][k])
            assert v.dtype == w.dtype and v.shape == w.shape and v.tobytes() == w.tobytes()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_loads_across_packages(writer, tmp_path):
    """Trained sine params, saved by one package, load in the other with
    equal bits (and in the writer itself)."""
    m = tmodels.sine_trainable(device="cpu")
    x = np.linspace(0, 2 * np.pi, 16, dtype=np.float32).reshape(-1, 1)
    m.predict_train(x, m.quantize_target(x / 4), 0.05)
    m.update_layers(16, 0.05)
    params = {k: {kk: v.numpy() for kk, v in d.items()} for k, d in m.params.items()}
    path = str(tmp_path / "ck.npz")
    if writer == "port":
        save_params(path, m.params)
    else:
        jcheckpoint.save_params(path, params)
    port = load_params(path, "cpu")
    assert all(v.device.type == "cpu" for d in port.values() for v in d.values())
    assert_params_equal({k: {kk: v.numpy() for kk, v in d.items()} for k, d in port.items()},
                        params)
    assert_params_equal(jax.tree_util.tree_map(np.asarray, jcheckpoint.load_params(path)),
                        params)
    m2 = tmodels.sine_trainable(device="cpu")
    m2.params = port
    xq = m.quantize_input(x)
    assert torch.equal(m2.predict_inner(xq), m.predict_inner(xq))


def test_samples_features_equal_jax():
    got, want = tsamples.load_features(), jsamples.load_features()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k
    assert (tsamples.SPEECH_LABELS, tsamples.PERSON_DETECT_LABELS) == (
        jsamples.SPEECH_LABELS, jsamples.PERSON_DETECT_LABELS)


def write_bmp(path, img: np.ndarray, bottom_up: bool):
    """An 8bpp uncompressed BMP with a 256-entry gray palette, rows padded to
    4 bytes, stored bottom-up (positive height) or top-down."""
    h, w = img.shape
    stride = (w + 3) & ~3
    rows = img[::-1] if bottom_up else img
    pixels = b"".join(r.tobytes() + b"\0" * (stride - w) for r in rows)
    palette = b"".join(bytes((i, i, i, 0)) for i in range(256))
    off = 14 + 40 + len(palette)
    header = b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off)
    info = struct.pack("<IiiHHIIiiII", 40, w, h if bottom_up else -h, 1, 8, 0, len(pixels),
                       2835, 2835, 256, 0)
    with open(path, "wb") as f:
        f.write(header + info + palette + pixels)


@pytest.mark.parametrize("bottom_up", [True, False])
@pytest.mark.parametrize("width", [7, 8])
def test_decode_bmp_equals_jax(tmp_path, bottom_up, width):
    img = np.random.default_rng(width).integers(0, 256, (5, width), dtype=np.uint8)
    path = str(tmp_path / "img.bmp")
    write_bmp(path, img, bottom_up)
    got = tsamples.decode_bmp_gray8(path)
    assert np.array_equal(got, img)
    assert np.array_equal(got, jsamples.decode_bmp_gray8(path))
    feat = tsamples.image_to_features(got)
    assert feat.tobytes() == jsamples.image_to_features(got).tobytes()
    assert feat.dtype == np.int8 and feat.shape == (1, 5, width, 1)


def test_samples_classify_on_the_cpu():
    """The JAX package's sample goldens (tests/test_samples.py) through the
    port's ``auto`` on the CPU."""
    feats = tsamples.load_features()
    pd = tmodels.person_detect(device="cpu")
    person = pd.predict_quantized(feats["person_detect_person"])[0].numpy()
    no_person = pd.predict_quantized(feats["person_detect_no_person"])[0].numpy()
    assert np.array_equal(person, np.array([0.26953125, 0.73046875], np.float32))
    assert np.array_equal(no_person, np.array([0.6171875, 0.3828125], np.float32))
    sp = tmodels.speech(device="cpu")
    yes = sp.predict_quantized(feats["speech_yes"])[0].numpy()
    no = sp.predict_quantized(feats["speech_no"])[0].numpy()
    assert tsamples.SPEECH_LABELS[int(np.argmax(yes))] == "yes" and yes[2] == np.float32(0.99609375)
    assert tsamples.SPEECH_LABELS[int(np.argmax(no))] == "no" and no[3] == np.float32(0.9453125)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_time_predict_on_the_cpu(backend):
    r = time_predict(tmodels.sine(backend=backend, device="cpu"), batch_size=32, iters=3)
    assert r["device"] == "cpu" and r["backend"] == backend and r["batch"] == 32
    assert r["ms_per_batch"] > 0 and r["inferences_per_s"] > 0 and r["tmacs_per_s"] > 0


@pytest.mark.parametrize("name", BUNDLED)
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_expansion_names_every_layer(name, backend, tmp_path):
    m = compile_tflite(model_path(name), name=name, backend=backend, device="cpu")
    text = m.expansion(batch_size=3)
    assert text.startswith(layer_table(m.graph))
    assert f"backend: {backend}   device: cpu   batch: 3" in text
    body = text.split("batch: 3", 1)[1]
    for layer in m.graph.layers:
        kind = type(layer).__name__.replace("Layer", "")
        assert f"[{layer.index:>2}] {kind}" in body, layer.index
    plain = ("qgemm_reference", "qdwconv_reference") if backend == "pallas" else (
        "ops.fully_connected", "ops.conv_2d", "ops.depthwise_conv_2d")
    assert any(p in body for p in plain)
    assert "csrc/" not in body  # nothing on the CPU names a kernel that runs
    path = dump_expansion(m, str(tmp_path / "out" / "expansion.txt"), batch_size=3)
    with open(path) as f:
        assert f.read() == text + "\n"


@pytest.mark.parametrize("name,backend,entry", [
    ("person_detect", "flat", "flat_kernel<R_EXACT2> (csrc/flatpack.cu"),
    ("sine", "colfc", "col_kernel (csrc/colfc.cu"),
    ("person_detect", "pallas", "qdwconv_tile (csrc/qdwconv.cu, path stem)"),
])
def test_expansion_names_the_kernels_of_a_cuda_model(name, backend, entry):
    """What a model on the card would print, from one built on the CPU whose
    device is then set to CUDA (the description reads only the plans)."""
    m = compile_tflite(model_path(name), name=name, backend=backend, device="cpu")
    m.device = torch.device("cuda")
    text = m.expansion(batch_size=8192)
    assert entry in text
    if backend == "flat":
        fn = m._flat[0]
        assert len(fn.ops) == 30 and text.count("  pw_mma") == 13
        for op, path in zip(fn.ops, fn.paths):
            assert f"layer {op.layer_idx:>2} {op.kind:<9}" in text and path in text
    if backend == "pallas":
        assert text.count("qgemm_mma (csrc/qgemm.cu") == 10
        assert text.count("qgemm_rows (csrc/qgemm.cu") == 4
        assert text.count("qdwconv_tile") == 14

