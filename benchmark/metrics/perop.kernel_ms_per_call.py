"""Device time of the program's per-op kernels (``qgemm*``, ``qdwconv*``)
in the traced slice, per ``predict_inner`` call, in ms."""

from benchmark.metrics._common import is_port_kernel


def read(reading):
    t, calls = reading.trace, reading.counters.get("calls_traced")
    if t is None or not calls:
        return None
    value = t.device_seconds(is_port_kernel) / calls
    return 1e3 * value if value > 0 else None
