"""microflow_tpu_torch: the PyTorch and CUDA port of microflow_tpu.

It parses a ``.tflite`` flatbuffer into the same folded-constant IR as the
JAX package, runs batched int8 inference with the reference's exact
integer and f32 algebra and trains on the integer path (``train/``), on
an NVIDIA H100 through hand-written CUDA kernels (``kernels/``), or on the
CPU through their plain torch versions when the caller asks for
``device="cpu"``.  It imports neither JAX nor
``microflow_tpu``.
"""

from .compiler import CompiledModel, build, compile_tflite, params_from_numpy
from .frontend import parse
from .train import TrainableModel, compile_tflite_train, grads_from_numpy, grads_to_numpy

__version__ = "0.1.0"

__all__ = ["CompiledModel", "TrainableModel", "build", "compile_tflite", "compile_tflite_train",
           "grads_from_numpy", "grads_to_numpy", "params_from_numpy", "parse"]
