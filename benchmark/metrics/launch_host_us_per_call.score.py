"""Host time of the program's span ``mft.flat.launch`` (the whole-network
kernel's launch inside ``predict_inner``: the output's allocation, the
ctypes call, the error check), in microseconds: the median over the
window's calls before the traced slice."""

from benchmark.metrics._spans import CALL, median_duration


def read(reading):
    return median_duration(reading, CALL, "mft.flat.launch", 1e-6)
