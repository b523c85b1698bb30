"""The share of the conv layers whose weight gradients the ``qwgrad``
kernel folded, in %, over the window's train steps before the traced
slice: the program's counters ``mft.train.wgrad_folds`` (the kernel) and
``mft.train.wgrad_plain`` (plain torch) as each ``mft.train.step`` span saw
them move.  None where the program has no such counters, or its steps
folded no conv layer."""

from benchmark.metrics._spans import STEP, window_records

FOLDS = "mft.train.wgrad_folds"
PLAIN = "mft.train.wgrad_plain"


def read(reading):
    try:
        from microflow_tpu_torch.utils import trace
    except ImportError:
        return None
    if FOLDS not in trace.COUNTERS:
        return None
    steps = window_records(reading, STEP, STEP[0])
    counts = [dict(getattr(r, "counts", ())) for r in steps]
    folds = sum(c.get(FOLDS, 0) for c in counts)
    total = folds + sum(c.get(PLAIN, 0) for c in counts)
    return 100.0 * folds / total if total else None
