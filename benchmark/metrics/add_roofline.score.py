"""The ``ADD`` kernels' share of their roofline, in %: the bytes the graph's
``ADD`` layers move for the rows of the traced slice (``_residual.py``)
over the card's HBM bandwidth, against the device time of the ``qadd``
kernels in the slice."""

from benchmark.costs import PEAK_HBM_BYTES_PER_S
from benchmark.metrics._residual import add_bytes_per_inference, is_qadd


def read(reading):
    t, c = reading.trace, reading.counters
    if t is None or not c.get("calls_traced"):
        return None
    kernel_s = t.device_seconds(is_qadd)
    moved = add_bytes_per_inference(reading.graph) * c["batch"] * c["calls_traced"]
    if kernel_s <= 0 or moved <= 0:
        return None
    return 100.0 * moved / PEAK_HBM_BYTES_PER_S / kernel_s
