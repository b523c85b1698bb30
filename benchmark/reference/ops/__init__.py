"""Quantized operators in plain torch: the exact oracle every kernel of the
port is held against (the role ``microflow_tpu.ops`` plays for XLA)."""

from .average_pool_2d import average_pool_2d
from .conv_2d import conv_2d
from .depthwise_conv_2d import depthwise_conv_2d
from .fully_connected import fully_connected
from .quantize_op import quantize_op
from .reshape import reshape
from .softmax import softmax

__all__ = [
    "average_pool_2d",
    "conv_2d",
    "depthwise_conv_2d",
    "fully_connected",
    "quantize_op",
    "reshape",
    "softmax",
]
