"""Host time of the program's span ``mft.train.backward`` (a train step's
loss gradient and backward loop, the saturating fold within it), in ms:
the median over the window's steps before the traced slice."""

from benchmark.metrics._spans import STEP, median_duration


def read(reading):
    return median_duration(reading, STEP, "mft.train.backward", 1e-3)
