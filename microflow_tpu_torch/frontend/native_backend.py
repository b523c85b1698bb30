"""Adapter exposing the native (C++) parser's output through the same
duck-typed model interface as ``frontend.tflite``, with zero-copy weight
views into the model file's bytes.  The port's copy of
``microflow_tpu.frontend.native_backend``."""

from __future__ import annotations

import numpy as np

from .. import native
from . import tflite


class _Quantization:
    def __init__(self, d: dict):
        self.scale = np.asarray(d.get("scale", []), np.float32)
        self.zero_point = np.asarray(d.get("zero_point", []), np.int64)
        self.quantized_dimension = d.get("quantized_dimension", 0)


class _Tensor:
    def __init__(self, d: dict):
        self.shape = list(d["shape"])
        self.type = tflite.TensorType(d["type"])
        self.quantization = _Quantization(d)
        # ``buffer`` carries the (offset, length) of the payload so
        # NativeModel.buffer_data can slice the file bytes without a copy
        self.buffer = (d["data_offset"], d["data_len"])
        self.name = None


class _Options:
    def __init__(self, d: dict):
        self.padding = tflite.Padding(d.get("padding", 0))
        self.stride_w = d.get("stride_w", 0)
        self.stride_h = d.get("stride_h", 0)
        self.depth_multiplier = d.get("depth_multiplier", 0)
        self.filter_width = d.get("filter_width", 0)
        self.filter_height = d.get("filter_height", 0)
        self.fused_activation_function = tflite.ActivationFunctionType(
            d.get("fused_activation_function", 0)
        )
        self.keep_num_dims = bool(d.get("keep_num_dims", 0))
        self.dilation_w_factor = d.get("dilation_w_factor", 1)
        self.dilation_h_factor = d.get("dilation_h_factor", 1)


class _Operator:
    def __init__(self, d: dict):
        self.opcode_index = d["opcode_index"]
        self.inputs = list(d["inputs"])
        self.outputs = list(d["outputs"])
        self._options = _Options(d.get("options", {}))

    def conv_2d_options(self):
        return self._options

    def depthwise_conv_2d_options(self):
        return self._options

    def pool_2d_options(self):
        return self._options

    def fully_connected_options(self):
        return self._options

    def add_options(self):
        return self._options


class _OperatorCode:
    def __init__(self, d: dict):
        self.op = d["code"]


class _SubGraph:
    def __init__(self, meta: dict):
        self.tensors = [_Tensor(t) for t in meta["tensors"]]
        self.inputs = list(meta["inputs"])
        self.outputs = list(meta["outputs"])
        self.operators = [_Operator(o) for o in meta["operators"]]
        self.name = meta["name"]


class NativeModel:
    def __init__(self, buf: bytes):
        meta = native.parse_metadata(buf)
        self._buf = memoryview(buf)
        self.version = meta["version"]
        self.operator_codes = [_OperatorCode(c) for c in meta["operator_codes"]]
        self.subgraphs = [_SubGraph(meta)]
        # only subgraph 0 is materialized; the count lets the front end
        # reject multi-subgraph models instead of silently using index 0
        self.num_subgraphs = meta.get("num_subgraphs", 1)

    def buffer_data(self, ref) -> memoryview:
        offset, length = ref
        return self._buf[offset : offset + length]


def load_model(path: str) -> NativeModel:
    with open(path, "rb") as f:
        return NativeModel(f.read())
