"""The program's counter ``mft.graph.live_peak_bytes`` after the window, in
MB: the most activation bytes that the graph walk of the newest
``predict_inner`` call held at once, from the tensors' shapes.  None where
the program has no such counter, or no call ran."""

LIVE_PEAK = "mft.graph.live_peak_bytes"


def read(reading):
    if not reading.counters.get("calls"):
        return None
    try:
        from microflow_tpu_torch.utils import trace
    except ImportError:
        return None
    value = trace.COUNTERS.get(LIVE_PEAK)
    return value / 1e6 if value else None
