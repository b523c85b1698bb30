"""The port's synthetic models (``microflow_tpu_torch/models/synth.py``) are
the JAX package's byte for byte, and the port's parser reads each into the
JAX parser's graph."""

import pytest
from test_torch_frontend import assert_same

from microflow_tpu.frontend import parse as jparse
from microflow_tpu.models import synth as jsynth
from microflow_tpu_torch.frontend import parse as tparse
from microflow_tpu_torch.models import synth as tsynth

SYNTH = ("lenet", "full_ops", "flat_conv", "uint8_mlp", "per_channel_dw")


@pytest.mark.parametrize("gen", SYNTH)
def test_synth_bytes_equal_jax(gen, tmp_path):
    data = getattr(tsynth, gen)()
    assert data == getattr(jsynth, gen)()
    path = tsynth.write(str(tmp_path / f"{gen}.tflite"), data)
    with open(path, "rb") as f:
        assert f.read() == data
    assert_same(jparse(path, frontend="python"), tparse(path))


@pytest.mark.parametrize("gen", ["lenet", "full_ops"])
def test_synth_seed_moves_the_weights(gen):
    assert getattr(tsynth, gen)(seed=7) == getattr(jsynth, gen)(seed=7)
    assert getattr(tsynth, gen)(seed=7) != getattr(tsynth, gen)()
