"""The port's spans and counters, in one place.

A span times one layer of a call on the host's clock::

    with trace.Span("mft.train.forward"):
        ...

Each closed span leaves a ``Record``: its start and end
(``time.perf_counter_ns``), the name of the span open around it on the
same thread, the identifier of the train step or ``predict_inner`` call
it belongs to, the ``mft.host_waits`` counted while it was open, and
what the other ``COUNTERS`` counted while it was open.  A span opened
with ``root=True``, or with no span open around it, takes the next
identifier of its own name; every other span takes its parent's.
The records go into a buffer per span name that keeps the newest
``CAP``; ``records(name)`` reads it.

While a torch profiler runs, a span also enters a record function of its
name, so that the profiler's trace shows it on the host's timeline beside
the device's work; with none running it touches nothing of torch.  It is
the function-scope record function that operators use
(``torch._C._profiler._RecordFunctionFast``): a user-scope one
(``torch.profiler.record_function``) is also copied onto the device's
timeline as an annotation over the kernels it launched, which a reader of
the trace would count as device work.  No span reads the device or waits
for it.

Counters: ``LAUNCHES``, kernel launches by kernel name (each kernel's
wrapper counts its own, and a replayed CUDA graph those it captured);
``COUNTERS[HOST_WAITS]``, each copy between the host and a device that
the program makes through ``core.numerics``' ``const_f32``, ``const_int``,
``as_device`` and ``read_host``; ``COUNTERS[GRAPH_STEPS]``, each train
step that replayed its forward, backward and update as CUDA graphs, and
``COUNTERS[EAGER_STEPS]``, each other train step (``train/trainer.py``);
``COUNTERS[WGRAD_FOLDS]`` and ``COUNTERS[WGRAD_PLAIN]``, each conv layer of
a train step whose weight gradient was folded into its accumulator by the
``qwgrad`` kernel, or by plain torch (a replayed step counts the layers
its capture took each way);
``COUNTERS[LIVE_PEAK]``, a level and not a count: the most activation
bytes that the newest forward of a graph with wiring held at once
(``CompiledModel._walk``, which also opens a span ``ADD_SPAN`` around each
``ADD`` it issues).
``snapshot()`` gives an operator each span's count, median and total and
the counters, as ``BatchServer.stats()`` does for the server.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import Counter, deque
from typing import NamedTuple

import torch

CAP = 8192  # records kept a span name, the newest
HOST_WAITS = "mft.host_waits"
GRAPH_STEPS = "mft.train.graph_steps"
EAGER_STEPS = "mft.train.eager_steps"
WGRAD_FOLDS = "mft.train.wgrad_folds"
WGRAD_PLAIN = "mft.train.wgrad_plain"
LIVE_PEAK = "mft.graph.live_peak_bytes"
ADD_SPAN = "mft.op.add"

LAUNCHES: Counter = Counter()
COUNTERS: Counter = Counter({HOST_WAITS: 0, GRAPH_STEPS: 0, EAGER_STEPS: 0, WGRAD_FOLDS: 0,
                             WGRAD_PLAIN: 0})


class Record(NamedTuple):
    start: int  # ns, time.perf_counter_ns
    end: int
    parent: str | None  # the name of the span open around this one
    ident: int  # the train step or predict_inner call it belongs to
    waits: int  # COUNTERS[HOST_WAITS] counted while it was open
    counts: tuple = ()  # (name, count) of the other COUNTERS that moved while it was open


_records: dict[str, deque] = {}  # name -> deque of Record's fields, as tuples
_idents: dict[str, itertools.count] = {}
_totals: dict[str, list[int]] = {}  # name -> [count, total ns], over every record
_lock = threading.Lock()
_local = threading.local()
_profiling = torch._C._autograd._profiler_enabled
record_function = torch._C._profiler._RecordFunctionFast


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``COUNTERS[name]``."""
    with _lock:
        COUNTERS[name] += n


def level(name: str, value: int) -> None:
    """Set ``COUNTERS[name]`` to ``value``: a level, the newest reading."""
    with _lock:
        COUNTERS[name] = value


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span, bound by a ``with``.  Where one ``with`` cannot bound it (a
    train step runs from ``predict_quantized_train`` to the end of
    ``update_layers``), ``open`` and ``close`` do, and ``suspend`` and
    ``resume`` take it off its thread's stack of open spans between the
    calls, so that nothing the caller does between them nests in it."""

    __slots__ = ("name", "root", "parent", "ident", "start", "counters", "_stack", "_rf")

    def __init__(self, name: str, root: bool = False):
        self.name = name
        self.root = root

    def open(self) -> "Span":
        stack = _stack()
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        if self.root or outer is None:
            idents = _idents.get(self.name) or _idents.setdefault(self.name, itertools.count())
            self.ident = next(idents)
        else:
            self.ident = outer.ident
        self._rf = None
        if _profiling():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        self.resume()
        self.counters = dict(COUNTERS)
        self.start = time.perf_counter_ns()
        return self

    def suspend(self) -> None:
        stack = self._stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)

    def resume(self) -> None:
        self._stack = _stack()
        self._stack.append(self)

    def close(self) -> None:
        end = time.perf_counter_ns()
        before, now = self.counters, dict(COUNTERS)
        waits = now[HOST_WAITS] - before[HOST_WAITS]
        counts = tuple((k, n - before.get(k, 0)) for k, n in now.items()
                       if k != HOST_WAITS and n != before.get(k, 0))
        self.suspend()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        rec = (self.start, end, self.parent, self.ident, waits, counts)
        with _lock:
            buf = _records.get(self.name)
            if buf is None:
                buf = _records[self.name] = deque(maxlen=CAP)
                _totals[self.name] = [0, 0]
            buf.append(rec)
            total = _totals[self.name]
            total[0] += 1
            total[1] += end - self.start

    def __enter__(self) -> "Span":
        return self.open()

    def __exit__(self, *exc) -> None:
        self.close()


def records(name: str) -> list[Record]:
    """The buffered records of the span ``name``, oldest first."""
    with _lock:
        return [Record(*r) for r in _records.get(name, ())]


def _median(values: list) -> float:
    values = sorted(values)
    mid = len(values) // 2
    return values[mid] if len(values) % 2 else (values[mid - 1] + values[mid]) / 2


def snapshot() -> dict:
    """``{"spans": {name: {"count", "p50_ms", "total_ms"}}, "counters": {...},
    "launches": {...}}``: ``count`` and ``total_ms`` over every record of the
    process, ``p50_ms`` over the buffered ones."""
    with _lock:
        spans = {name: {"count": _totals[name][0],
                        "p50_ms": _median([r[1] - r[0] for r in buf]) / 1e6,
                        "total_ms": _totals[name][1] / 1e6}
                 for name, buf in _records.items()}
        counters = dict(COUNTERS)
    return {"spans": spans, "counters": counters, "launches": dict(LAUNCHES)}

