"""The torch port's front end (``microflow_tpu_torch.frontend``) against the
JAX package's Python parser: every Graph field equal, bit for bit, on the
bundled models and the synthetic zoo, and the same loud rejections."""

import dataclasses
import enum
import os

import numpy as np
import pytest
import test_fuzz_frontend as fz

from microflow_tpu.frontend import parse as jparse
from microflow_tpu.frontend.tflite import ActivationFunctionType as Act
from microflow_tpu.frontend.tflite import Padding
from microflow_tpu.frontend.writer import ModelWriter
from microflow_tpu.models import synth
from microflow_tpu_torch.frontend import parse as tparse

MODELS = os.path.join(os.path.dirname(__file__), "..", "models")
SYNTH = ("lenet", "full_ops", "flat_conv", "uint8_mlp", "per_channel_dw")


def assert_same(a, b, path="graph"):
    """Structural equality across the two packages' IR classes."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, enum.Enum):
        assert (type(a).__name__, a.name, a.value) == (type(b).__name__, b.name, b.value), path
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.generic):
        assert type(a) is type(b) and a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b) and a == b, path


@pytest.mark.parametrize("name", ["sine", "speech", "person_detect"])
def test_graph_equal_bundled(name):
    path = os.path.join(MODELS, f"{name}.tflite")
    assert_same(jparse(path, frontend="python"), tparse(path))


@pytest.mark.parametrize("gen", SYNTH)
def test_graph_equal_synth(gen, tmp_path):
    path = synth.write(str(tmp_path / f"{gen}.tflite"), getattr(synth, gen)())
    assert_same(jparse(path, frontend="python"), tparse(path))


def _write(tmp_path, data):
    path = str(tmp_path / "m.tflite")
    with open(path, "wb") as f:
        f.write(data)
    return path


REJECTIONS = {
    "dilated_conv": (lambda: fz._conv_model(conv_fields=ModelWriter.conv_options(
        Padding.SAME, (1, 1), Act.NONE) + [(4, "i32", 2), (5, "i32", 2)]), "dilation"),
    "dilated_dwconv": (lambda: fz._conv_model(dw_fields=ModelWriter.dwconv_options(
        Padding.SAME, (1, 1), 2, Act.NONE) + [(5, "i32", 1), (6, "i32", 3)], dw_in_c=2),
        "dilation"),
    "fc_keep_num_dims": (lambda: fz._conv_model(
        fc_fields=ModelWriter.fc_options(Act.NONE) + [(2, "u8", 1)]), "keep_num_dims"),
    "multi_subgraph": (lambda: fz._conv_model(num_subgraphs=2), "subgraph"),
    "multi_input": (lambda: fz._conv_model(extra_input=True), "inputs"),
    "multi_output": (lambda: fz._conv_model(extra_output=True), "outputs"),
    "tanh_activation": (lambda: fz._conv_model(conv_fields=ModelWriter.conv_options(
        Padding.SAME, (1, 1), Act.TANH)), "activation"),
    "dw_channel_mismatch": (lambda: fz._conv_model(dw_in_c=2), "fallback"),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_loud_rejections(case, tmp_path):
    make, match = REJECTIONS[case]
    path = _write(tmp_path, make())
    with pytest.raises((NotImplementedError, ValueError), match=match):
        tparse(path)


def test_dw_stem_and_true_depthwise_parse(tmp_path):
    for in_c in (1, 4):
        path = _write(tmp_path, fz._conv_model(dw_in_c=in_c))
        assert_same(jparse(path, frontend="python"), tparse(path))


def test_rejects_non_tflite_and_native_frontend(tmp_path):
    path = _write(tmp_path, b"\x10\x00\x00\x00XXXX" + b"\x00" * 32)
    with pytest.raises(ValueError, match="not a TFLite model"):
        tparse(path)
    with pytest.raises(ValueError, match="invalid TFLite model"):
        tparse(path, frontend="native")
    with pytest.raises(ValueError, match="unknown frontend"):
        tparse(os.path.join(MODELS, "sine.tflite"), frontend="bogus")
