"""The program's counter ``mft.host_waits`` (copies between the host and
the card: uploads from pageable memory, reads of device values) within
each ``mft.train.step``: the median over the window's steps before the
traced slice."""

import statistics

from benchmark.metrics._spans import STEP, window_records


def read(reading):
    steps = window_records(reading, STEP, STEP[0])
    return statistics.median(r.waits for r in steps) if steps else None
