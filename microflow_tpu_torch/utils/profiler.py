"""Profiling aids (reference analog: criterion benches and the
macro-expansion dump ``target/microflow-expansion.rs``): the static layer
table, the expansion dump and a throughput timer."""

from __future__ import annotations

import os
import time

import torch

from ..compiler.ir import Graph
from ..core.numerics import torch_dtype
from .flops import layer_macs, macs_per_inference


def layer_table(graph: Graph) -> str:
    """Static per-layer cost table (MACs per inference)."""
    rows = ["idx  type                  out_shape           MACs"]
    for layer in graph.layers:
        rows.append(f"{layer.index:<4d} {type(layer).__name__:<20s}  "
                    f"{str(layer.out_shape):<18s}  {layer_macs(layer):,}")
    rows.append(f"total {macs_per_inference(graph):,} MACs/inference")
    return "\n".join(rows)


def dump_expansion(model, path: str = "target/microflow-expansion.txt",
                   batch_size: int = 1) -> str:
    """Write ``model.expansion(batch_size)`` (which begins with the layer
    table) to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(model.expansion(batch_size))
        f.write("\n")
    return path


WARMUP = 3  # calls before the timed ones: the kernels' first-use build and plan upload


def time_predict(model, batch_size: int = 512, iters: int = 30, seed: int = 0) -> dict:
    """Throughput of ``model.predict_inner`` on int8 inputs drawn from a
    ``torch.Generator`` seeded with ``seed``, after ``WARMUP`` calls: on a
    card, CUDA events around ``iters`` calls; on the CPU, the host clock.
    The result names the device it ran on."""
    g = model.graph
    dtype = torch_dtype(g.input_dtype)
    info = torch.iinfo(dtype)
    gen = torch.Generator().manual_seed(seed)
    xq = torch.randint(info.min, info.max + 1, (batch_size, *g.input_shape), generator=gen,
                       dtype=torch.int32).to(dtype).to(model.device)
    for _ in range(WARMUP):
        model.predict_inner(xq)
    if model.device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(model.device)
        start.record()
        for _ in range(iters):
            model.predict_inner(xq)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        device = torch.cuda.get_device_name(model.device)
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            model.predict_inner(xq)
        ms = (time.perf_counter() - t0) * 1e3 / iters
        device = "cpu"
    macs = macs_per_inference(g)
    return {
        "device": device,
        "backend": model.backend,
        "batch": batch_size,
        "ms_per_batch": ms,
        "inferences_per_s": batch_size / ms * 1e3,
        "tmacs_per_s": macs * batch_size / ms / 1e9,
    }
