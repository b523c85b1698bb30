"""Core tensor substrate: numerics, quantization, activations, geometry."""

from .activation import FusedActivation, apply_fused_activation, relu, relu6
from .numerics import f32, round_away, saturating_cast
from .quantize import dequantize, quantize
from .tensor import ViewGeometry, ViewPadding, extract_patches, reshape_2d, reshape_4d

__all__ = [
    "FusedActivation",
    "ViewGeometry",
    "ViewPadding",
    "apply_fused_activation",
    "dequantize",
    "extract_patches",
    "f32",
    "quantize",
    "relu",
    "relu6",
    "reshape_2d",
    "reshape_4d",
    "round_away",
    "saturating_cast",
]
