"""What the readers of the program's own spans and counters share
(``microflow_tpu_torch.utils.trace``, on the program's clock).

Each reads the records of the window's train steps or ``predict_inner``
calls that ran before the traced slice, so that no profiler was on while
they ran.  The cell's counters say how many there were (``steps`` and
``steps_traced``; ``calls`` and ``calls_traced``), and they were the last
steps or calls the program made: the newest identifiers of the root span
(``mft.train.step``, ``mft.predict``) less the traced ones.  Set-up's
steps and calls (the checked steps, the golden, the warm-up) come before
them.  A program without the module or the spans gives nothing."""

from __future__ import annotations

import statistics

STEP = ("mft.train.step", "steps", "steps_traced")
CALL = ("mft.predict", "calls", "calls_traced")


def window_records(reading, kind: tuple, name: str) -> list:
    """The records of span ``name`` that belong to the window's untraced
    steps or calls (``kind``: ``STEP`` or ``CALL``): the root span's own,
    or those of its children named ``name``."""
    root, total_key, traced_key = kind
    total = reading.counters.get(total_key)
    if not total:
        return []
    try:
        from microflow_tpu_torch.utils import trace
    except ImportError:
        return []
    roots = trace.records(root)
    if not roots:
        return []
    end = max(r.ident for r in roots) + 1
    first, last = end - total, end - reading.counters.get(traced_key, 0)
    if name == root:
        return [r for r in roots if first <= r.ident < last]
    return [r for r in trace.records(name) if first <= r.ident < last and r.parent == root]


def median_duration(reading, kind: tuple, name: str, unit_s: float):
    """The median duration of those records in units of ``unit_s``
    seconds, or None where there are none."""
    recs = window_records(reading, kind, name)
    if not recs:
        return None
    return statistics.median(r.end - r.start for r in recs) / (unit_s * 1e9)
