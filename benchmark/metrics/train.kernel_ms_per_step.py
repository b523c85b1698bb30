"""Device time of the program's own per-op kernels (``qgemm*``,
``qdwconv*``) in the traced slice, per train step, in ms."""

from benchmark.metrics._common import is_port_kernel


def read(reading):
    t, steps = reading.trace, reading.counters.get("steps_traced")
    if t is None or not steps:
        return None
    value = t.device_seconds(is_port_kernel) / steps
    return 1e3 * value if value > 0 else None
