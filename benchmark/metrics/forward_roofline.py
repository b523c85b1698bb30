"""The least time the card could take for one batch (``costs.py``: the
larger of the int8 operations over their peak and the input, output and
weight bytes over the HBM bandwidth), over the device time of all kernels
of one batch in the traced slice, in %."""

from benchmark.costs import least_forward_seconds


def read(reading):
    t, c = reading.trace, reading.counters
    if t is None or not c.get("calls_traced"):
        return None
    kernel_s = t.device_seconds(lambda n: not n.startswith(("Memcpy", "Memset")))
    if kernel_s <= 0:
        return None
    per_batch = kernel_s / c["calls_traced"]
    return 100.0 * least_forward_seconds(reading.graph, c["batch"]) / per_batch
