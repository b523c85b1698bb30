"""Device time in the traced slice, per ``predict_inner`` call, in ms, of
every kernel, copy and set that is neither a per-op kernel (``qgemm*``,
``qdwconv*``) nor an ``ADD`` kernel (``qadd*``): the per-op path's
``im2col``, weight transposes, column sums, pool and softmax, which a
one-launch kernel does not have."""

from benchmark.metrics._common import is_port_kernel
from benchmark.metrics._residual import is_qadd


def read(reading):
    t, calls = reading.trace, reading.counters.get("calls_traced")
    if t is None or not calls:
        return None
    value = t.device_seconds(lambda n: not (is_port_kernel(n) or is_qadd(n))) / calls
    return 1e3 * value if value > 0 else None
