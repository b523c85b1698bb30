"""Utilities: cost model, cosine similarity, checkpointing, the layer
table, the expansion dump and a throughput timer (the JAX package's
``utils/``, without its XLA executable cache: ``kernels/build.py`` caches
the built kernels)."""

from .checkpoint import load_params, save_params
from .cosine import cosine_similarity
from .flops import activation_bytes_per_inference, macs_per_inference, weight_bytes
from .profiler import dump_expansion, layer_table, time_predict

__all__ = [
    "activation_bytes_per_inference",
    "cosine_similarity",
    "dump_expansion",
    "layer_table",
    "load_params",
    "macs_per_inference",
    "save_params",
    "time_predict",
    "weight_bytes",
]
