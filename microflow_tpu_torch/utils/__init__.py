"""Utilities: cost model, cosine similarity, checkpointing, the layer
table, the expansion dump, a throughput timer (the JAX package's
``utils/``, without its XLA executable cache: ``kernels/build.py`` caches
the built kernels) and the port's spans and counters (``trace``).

Each name below is imported from its module at first use, so that the
modules that import ``utils.trace`` (``core.numerics`` among them) load
nothing else of the package with it."""

from importlib import import_module

_HOME = {
    "activation_bytes_per_inference": "flops",
    "cosine_similarity": "cosine",
    "dump_expansion": "profiler",
    "layer_table": "profiler",
    "load_params": "checkpoint",
    "macs_per_inference": "flops",
    "save_params": "checkpoint",
    "time_predict": "profiler",
    "weight_bytes": "flops",
}

__all__ = sorted(_HOME)


def __getattr__(name: str):
    if name in _HOME:
        return getattr(import_module(f".{_HOME[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
