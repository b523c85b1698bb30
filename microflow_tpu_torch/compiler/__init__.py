"""Graph compiler: tflite front-end output -> folded IR -> eager torch model."""

from .builder import CompiledModel, build, compile_tflite, params_from_numpy
from .ir import Graph

__all__ = ["CompiledModel", "Graph", "build", "compile_tflite", "params_from_numpy"]
