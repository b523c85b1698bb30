"""Model front-end: flatbuffer reader, TFLite schema accessors, parser."""

from .parser import parse
from .tflite import load_model

__all__ = ["load_model", "parse"]
