"""The share of the window's train steps before the traced slice that
replayed their forward, backward and update as CUDA graphs, in %: the
steps whose ``mft.train.step`` span saw the program's counter
``mft.train.graph_steps`` move.  None where the program has no such
counter."""

from benchmark.metrics._spans import STEP, window_records

GRAPH_STEPS = "mft.train.graph_steps"


def read(reading):
    try:
        from microflow_tpu_torch.utils import trace
    except ImportError:
        return None
    if GRAPH_STEPS not in trace.COUNTERS:
        return None
    steps = window_records(reading, STEP, STEP[0])
    if not steps:
        return None
    replayed = sum(1 for r in steps if dict(getattr(r, "counts", ())).get(GRAPH_STEPS))
    return 100.0 * replayed / len(steps)
