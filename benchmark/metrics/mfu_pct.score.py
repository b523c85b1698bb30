"""2 * MACs * rows completed in the traced slice, over its wall time,
against the card's published dense int8 peak, in %: the whole step's
share of the peak, which bounds every kernel's roofline share."""

from benchmark.costs import PEAK_INT8_OPS_PER_S, macs_per_inference


def read(reading):
    t, c = reading.trace, reading.counters
    if t is None or not c.get("calls_traced") or t.window_s <= 0 or t.busy_s <= 0:
        return None
    ops = 2.0 * macs_per_inference(reading.graph) * c["calls_traced"] * c["batch"]
    return 100.0 * ops / t.window_s / PEAK_INT8_OPS_PER_S
