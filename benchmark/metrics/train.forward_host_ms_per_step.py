"""Host time of the program's span ``mft.train.forward`` (a train step's
forward loop), in ms: the median over the window's steps before the
traced slice."""

from benchmark.metrics._spans import STEP, median_duration


def read(reading):
    return median_duration(reading, STEP, "mft.train.forward", 1e-3)
