"""Host time of the program's spans ``mft.op.add`` (the issue of each
``ADD`` in the graph walk of ``predict_inner``), summed over a call, in
microseconds: the median over the window's calls before the traced
slice."""

import statistics

from benchmark.metrics._spans import CALL, window_records


def read(reading):
    per_call: dict = {}
    for r in window_records(reading, CALL, "mft.op.add"):
        per_call[r.ident] = per_call.get(r.ident, 0) + (r.end - r.start)
    return statistics.median(per_call.values()) / 1e3 if per_call else None
