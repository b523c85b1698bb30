"""What the readers of a residual graph's cell share: the bytes its ``ADD``
layers move, and which device operations are its ``ADD`` kernels.

An ``ADD`` reads two int8 tensors and writes one, an element each, each
element once: ``3 * prod(out_shape)`` bytes a sample.  The graph is the
one the configuration's reference parses (``harness.reference_of``); a
layer is an ``ADD`` where it is that reference's ``Add``
(``benchmark/reference_residual``)."""

from __future__ import annotations

import numpy as np


def add_bytes_per_inference(graph) -> int:
    """Bytes the ``ADD`` layers of ``graph`` read and write for one sample."""
    from benchmark.reference_residual.model import Add

    return sum(3 * int(np.prod(layer.out_shape)) for layer in graph.layers
               if isinstance(layer, Add))


def is_qadd(name: str) -> bool:
    """One of the program's ``ADD`` kernels."""
    return "qadd" in name
