"""The port's ``ADD`` against the OFFICIAL TFLite runtime, bit for bit.

MicroFlow has no ``ADD``: the port takes TFLite's integer ``ADD``, so the
interpreter is its oracle for this op (and only for it: the port keeps
MicroFlow's padding and f32 requantization elsewhere, see
``test_tflite_interop.py``).  Both sides compute in integers, so there is
no 1-LSB allowance.  Each model is one ``ADD`` written by the port's
writer, with seeded scales and zero points and every fused activation the
parser takes; the port's fold and op (``ops/add.py``), the plain kernel
version (``kernels/qadd.py``) and the benchmark's plain reference
(``benchmark/reference_residual``) each compute it.  An ``ADD`` of one
tensor with itself is a one-input graph and runs through the whole of
``predict_inner``.
"""

import sys

import numpy as np
import pytest
import torch
from test_tflite_interop import _interpreter_cls

from benchmark.reference_residual import model as plain
from microflow_tpu_torch.compiler import folding
from microflow_tpu_torch.compiler.builder import build
from microflow_tpu_torch.compiler.ir import AddLayer, QuantInfo
from microflow_tpu_torch.core.activation import FusedActivation
from microflow_tpu_torch.frontend import parse
from microflow_tpu_torch.frontend.tflite import ActivationFunctionType as Act
from microflow_tpu_torch.frontend.tflite import BuiltinOperator as Op
from microflow_tpu_torch.frontend.tflite import TensorType
from microflow_tpu_torch.frontend.writer import ModelWriter
from microflow_tpu_torch.kernels.qadd import qadd_reference
from microflow_tpu_torch.ops.add import add

Interpreter = _interpreter_cls()
SHAPE = (1, 6, 5, 8)
ACTS = {Act.NONE: FusedActivation.NONE, Act.RELU: FusedActivation.RELU,
        Act.RELU6: FusedActivation.RELU6}
# The oracle is TFLite's reference kernels (``BUILTIN_REF``) at every drawn
# scale.  The interpreter's default (``AUTO``) hands the ADD to the XNNPACK
# delegate, another implementation, which agrees only where each input's
# scale is under 2**8 times the output's, its documented range (past it:
# 127 where TFLite gives -117); its optimized builtin kernel
# (``BUILTIN_WITHOUT_DEFAULT_DELEGATES``) departs already at ratios of
# about 190, and is not compared.  MobileNetV2's ratios lie near 1.
XNNPACK_MAX_RATIO = 2.0**8


def interpreter(data: bytes, resolver: str):
    kinds = getattr(sys.modules[Interpreter.__module__], "OpResolverType")
    it = Interpreter(model_content=data,
                     experimental_op_resolver_type=getattr(kinds, resolver))
    it.allocate_tensors()
    return it


def draw(seed: int):
    """Three (scale, zero point) pairs over three decades, and an activation."""
    rng = np.random.default_rng([seed, 25])
    qs = [(float(np.float32(10 ** rng.uniform(-3.5, 0.5))), int(rng.integers(-128, 128)))
          for _ in range(3)]
    return qs, list(ACTS)[seed % 3]


def resolvers(seeds) -> list:
    """(seed, resolver) pairs: the reference kernels for every seed, the
    default where the delegate's range holds."""
    pairs = [(s, "BUILTIN_REF") for s in seeds]
    for s in seeds:
        qs, _ = draw(s)
        if max(qs[0][0], qs[1][0]) / qs[2][0] < XNNPACK_MAX_RATIO:
            pairs.append((s, "AUTO"))
    return pairs


def one_add(qs, act, same_input: bool) -> bytes:
    m = ModelWriter("one add")
    a = m.tensor(list(SHAPE), TensorType.INT8, *qs[0], name="a")
    b = a if same_input else m.tensor(list(SHAPE), TensorType.INT8, *qs[1], name="b")
    o = m.tensor(list(SHAPE), TensorType.INT8, *qs[2], name="o")
    m.add_op(Op.ADD, [a, b], [o], m.add_options(act))
    return m.finish([a] if same_input else [a, b], [o])


def quant(s, z) -> QuantInfo:
    return QuantInfo(np.array([s], np.float32), np.array([z], np.int64))


@pytest.mark.parametrize("seed,resolver", resolvers(range(16)))
def test_add_matches_the_official_interpreter(seed, resolver):
    qs, act = draw(seed)
    it = interpreter(one_add(qs, act, same_input=False), resolver)
    rng = np.random.default_rng(seed)
    x1 = rng.integers(-128, 128, SHAPE, dtype=np.int8)
    x2 = rng.integers(-128, 128, SHAPE, dtype=np.int8)
    ins = it.get_input_details()
    it.set_tensor(ins[0]["index"], x1)
    it.set_tensor(ins[1]["index"], x2)
    it.invoke()
    want = it.get_tensor(it.get_output_details()[0]["index"])
    q1, q2, qo = (quant(*q) for q in qs)
    layer = AddLayer(0, q1, q2, qo, **folding.preprocess_add(q1, q2, qo, ACTS[act]),
                     activation=ACTS[act], out_shape=SHAPE[1:])
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    ref = plain._add_layer(0, q1, q2, qo, plain.FusedActivation[ACTS[act].name], SHAPE[1:])
    for got in (add(t1, t2, layer), qadd_reference(t1, t2, layer), plain.add(ref, t1, t2)):
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,resolver", resolvers(range(100, 103)))
def test_add_of_a_tensor_with_itself_through_predict(seed, resolver, tmp_path):
    qs, act = draw(seed)
    data = one_add(qs, act, same_input=True)
    it = interpreter(data, resolver)
    x = np.random.default_rng(seed).integers(-128, 128, SHAPE, dtype=np.int8)
    it.set_tensor(it.get_input_details()[0]["index"], x)
    it.invoke()
    want = it.get_tensor(it.get_output_details()[0]["index"])
    path = str(tmp_path / "add.tflite")
    with open(path, "wb") as f:
        f.write(data)
    for frontend in ("python", "native"):
        for backend in ("xla", "pallas"):
            model = build(parse(path, frontend=frontend), backend=backend, device="cpu")
            assert np.array_equal(model.predict_inner(torch.from_numpy(x)).numpy(), want)
    assert np.array_equal(plain.Reference(path, "cpu").forward(torch.from_numpy(x)).numpy(),
                          want)
