"""The benchmark's own host-clock span around each ``predict_inner`` call
of the window outside the traced slice (the enqueue; no synchronise), in
microseconds, as a mean over the calls."""


def read(reading):
    value = reading.counters.get("host_us_per_call")
    return value if value else None
