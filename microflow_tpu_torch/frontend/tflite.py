"""Typed accessors for the TFLite schema v3 (file identifier ``TFL3``).

Field ids follow ``microflow-macros/flatbuffers/tflite.fbs`` (the standard
public TFLite schema; union fields consume two vtable slots).
"""

from __future__ import annotations

import enum

import numpy as np

from .flatbuffer import Table, file_identifier, root_table


class TensorType(enum.IntEnum):
    FLOAT32 = 0
    FLOAT16 = 1
    INT32 = 2
    UINT8 = 3
    INT64 = 4
    STRING = 5
    BOOL = 6
    INT16 = 7
    COMPLEX64 = 8
    INT8 = 9

    @property
    def np_dtype(self):
        return {
            TensorType.FLOAT32: np.float32,
            TensorType.INT32: np.int32,
            TensorType.UINT8: np.uint8,
            TensorType.INT64: np.int64,
            TensorType.INT16: np.int16,
            TensorType.INT8: np.int8,
        }[self]


class BuiltinOperator(enum.IntEnum):
    ADD = 0
    AVERAGE_POOL_2D = 1
    CONV_2D = 3
    DEPTHWISE_CONV_2D = 4
    FULLY_CONNECTED = 9
    RESHAPE = 22
    SOFTMAX = 25
    QUANTIZE = 114


class BuiltinOptionsType(enum.IntEnum):
    NONE = 0
    CONV_2D = 1
    DEPTHWISE_CONV_2D = 2
    POOL_2D = 5
    FULLY_CONNECTED = 8
    SOFTMAX = 9
    ADD = 11


class Padding(enum.IntEnum):
    SAME = 0
    VALID = 1


class ActivationFunctionType(enum.IntEnum):
    NONE = 0
    RELU = 1
    RELU_N1_TO_1 = 2
    RELU6 = 3
    TANH = 4
    SIGN_BIT = 5


class Quantization:
    def __init__(self, t: Table | None):
        if t is None:
            self.scale = np.empty(0, np.float32)
            self.zero_point = np.empty(0, np.int64)
            self.quantized_dimension = 0
        else:
            self.scale = t.vector_numeric(2, np.float32)
            self.zero_point = t.vector_numeric(3, np.int64)
            self.quantized_dimension = t.int32(6)


class Tensor:
    def __init__(self, t: Table):
        self.shape = t.vector_numeric(0, np.int32).tolist()
        self.type = TensorType(t.int8(1))
        self.buffer = t.uint32(2)
        self.name = t.string(3)
        self.quantization = Quantization(t.table(4))


class Operator:
    def __init__(self, t: Table):
        self.opcode_index = t.uint32(0)
        self.inputs = t.vector_numeric(1, np.int32).tolist()
        self.outputs = t.vector_numeric(2, np.int32).tolist()
        self.builtin_options_type = t.uint8(3)
        self._options = t.table(4)

    # typed option decoders
    def conv_2d_options(self) -> "Conv2DOptions":
        return Conv2DOptions(self._options)

    def depthwise_conv_2d_options(self) -> "DepthwiseConv2DOptions":
        return DepthwiseConv2DOptions(self._options)

    def pool_2d_options(self) -> "Pool2DOptions":
        return Pool2DOptions(self._options)

    def fully_connected_options(self) -> "FullyConnectedOptions":
        return FullyConnectedOptions(self._options)

    def add_options(self) -> "AddOptions":
        return AddOptions(self._options)


class SubGraph:
    def __init__(self, t: Table):
        self.tensors = [Tensor(x) for x in t.vector_tables(0)]
        self.inputs = t.vector_numeric(1, np.int32).tolist()
        self.outputs = t.vector_numeric(2, np.int32).tolist()
        self.operators = [Operator(x) for x in t.vector_tables(3)]
        self.name = t.string(4)


class OperatorCode:
    def __init__(self, t: Table):
        self.deprecated_builtin_code = t.int8(0)
        self.version = t.int32(2, 1)
        self.builtin_code = t.int32(3)

    @property
    def op(self) -> int:
        # pre-2.3 models carry the code in the deprecated byte field
        # (the reference reads only this field,
        # ``microflow-macros/src/lib.rs:116-122``)
        return max(self.deprecated_builtin_code, self.builtin_code)


class Model:
    def __init__(self, buf: bytes):
        if file_identifier(buf) != "TFL3":
            raise ValueError(f"not a TFLite model (identifier {file_identifier(buf)!r})")
        root = root_table(buf)
        self.version = root.uint32(0)
        self.operator_codes = [OperatorCode(t) for t in root.vector_tables(1)]
        self.subgraphs = [SubGraph(t) for t in root.vector_tables(2)]
        self.description = root.string(3)
        self._buffer_tables = root.vector_tables(4)

    def buffer_data(self, index: int) -> bytes:
        return self._buffer_tables[index].vector_bytes(0)


def load_model(path: str) -> Model:
    with open(path, "rb") as f:
        return Model(f.read())


# --- builtin option decoders -------------------------------------------------


class Conv2DOptions:
    def __init__(self, t: Table | None):
        t = t or _EMPTY
        self.padding = Padding(t.int8(0))
        self.stride_w = t.int32(1)
        self.stride_h = t.int32(2)
        self.fused_activation_function = ActivationFunctionType(t.int8(3))
        self.dilation_w_factor = t.int32(4, 1)
        self.dilation_h_factor = t.int32(5, 1)


class DepthwiseConv2DOptions:
    def __init__(self, t: Table | None):
        t = t or _EMPTY
        self.padding = Padding(t.int8(0))
        self.stride_w = t.int32(1)
        self.stride_h = t.int32(2)
        self.depth_multiplier = t.int32(3)
        self.fused_activation_function = ActivationFunctionType(t.int8(4))
        self.dilation_w_factor = t.int32(5, 1)
        self.dilation_h_factor = t.int32(6, 1)


class Pool2DOptions:
    def __init__(self, t: Table | None):
        t = t or _EMPTY
        self.padding = Padding(t.int8(0))
        self.stride_w = t.int32(1)
        self.stride_h = t.int32(2)
        self.filter_width = t.int32(3)
        self.filter_height = t.int32(4)
        self.fused_activation_function = ActivationFunctionType(t.int8(5))


class FullyConnectedOptions:
    def __init__(self, t: Table | None):
        t = t or _EMPTY
        self.fused_activation_function = ActivationFunctionType(t.int8(0))
        self.keep_num_dims = bool(t.uint8(2))


class AddOptions:
    def __init__(self, t: Table | None):
        t = t or _EMPTY
        self.fused_activation_function = ActivationFunctionType(t.int8(0))


class _EmptyTable:
    """Stands in for an absent options table: every field at default."""

    def int8(self, fid, default=0):
        return default

    def int32(self, fid, default=0):
        return default

    def uint8(self, fid, default=0):
        return default


_EMPTY = _EmptyTable()
