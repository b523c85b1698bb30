"""The traced slice of a run: ``torch.profiler`` around the last seconds of
the window, reduced to what the per-layer readers and the breakdown need.

``Slice`` starts the profiler after a synchronise, so that the device
work it records is the work the slice issued, and stops it after the
driver's closing synchronise.  ``TraceSummary`` holds the device
intervals (kernels, copies, sets) and the host operators of the slice,
and works out:

* ``busy_s``: the union of the device intervals, clipped to the slice
  (a sum would count overlapping work twice);
* ``window_s``: the slice's wall span, from the benchmark's own span
  ``bench.slice`` around it;
* ``device_seconds(match)``: the summed device time of the intervals
  whose name ``match`` accepts;
* ``breakdown()``: the device operations that took most time, and the
  longest idle gaps named by the innermost host operator that covers
  most of each gap.
"""

from __future__ import annotations

import numpy as np
import torch

SLICE_SPAN = "bench.slice"
MAX_GAPS_NAMED = 500  # the longest idle gaps that the breakdown names


def _is_device(ev) -> bool:
    return ev.device_type == torch.autograd.DeviceType.CUDA


class Slice:
    """The profiler over the last part of a window (``start``, ``stop``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.active = False
        self._prof = self._span = None

    def _activities(self) -> list:
        from torch.profiler import ProfilerActivity

        if self.device.type == "cuda":
            return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        return [ProfilerActivity.CPU]

    def prepare(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        initialises the device's tracing, which takes seconds, and would
        otherwise eat the slice."""
        from torch.profiler import profile

        with profile(activities=self._activities()):
            torch.ones(1, device=self.device).add_(1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import profile, record_function

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=self._activities())
        self._prof.__enter__()
        self._span = record_function(SLICE_SPAN)
        self._span.__enter__()
        self.active = True

    def stop(self) -> "TraceSummary | None":
        """Close the slice (the caller has synchronised) and reduce it."""
        if self._prof is None:
            return None
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False
        return TraceSummary(self._prof.events())


class TraceSummary:
    def __init__(self, events):
        dev, host = [], []
        span = None
        for ev in events:
            tr = ev.time_range
            if ev.name == SLICE_SPAN:  # its host span; its copy on the device timeline is no work
                if not _is_device(ev):
                    span = (tr.start, tr.end)
            elif _is_device(ev):
                dev.append((ev.name, tr.start, tr.end))
            else:
                host.append((ev.name, tr.start, tr.end))
        if span is None:
            starts = [s for _, s, _ in dev + host]
            ends = [e for _, _, e in dev + host]
            span = (min(starts, default=0.0), max(ends, default=0.0))
        self.span = span  # microseconds, the profiler's clock
        self.device = [(n, max(s, span[0]), min(e, span[1])) for n, s, e in dev
                       if e > span[0] and s < span[1]]
        self.host = host

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) / 1e6

    def _union(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._union()) / 1e6

    def device_seconds(self, match) -> float:
        return sum(e - s for n, s, e in self.device if match(n)) / 1e6

    def gaps(self) -> list[tuple[float, float]]:
        """The idle intervals of the device within the slice."""
        out, t = [], self.span[0]
        for s, e in self._union():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.span[1] > t:
            out.append((t, self.span[1]))
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_op: dict[str, float] = {}
        for n, s, e in self.device:
            by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
        device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:MAX_GAPS_NAMED]
        by_host: dict[str, float] = {}
        if gaps:
            names = [n for n, _, _ in self.host]
            starts = np.array([s for _, s, _ in self.host] or [0.0])
            ends = np.array([e for _, _, e in self.host] or [0.0])
            lengths = ends - starts
            for gs, ge in gaps:
                overlap = np.minimum(ends, ge) - np.maximum(starts, gs)
                # the innermost operator that covers at least half the gap
                ok = overlap >= 0.5 * (ge - gs)
                if names and ok.any():
                    idx = np.flatnonzero(ok)
                    name = names[idx[np.argmin(lengths[idx])]]
                else:
                    name = "(no profiled host operator)"
                by_host[name] = by_host.get(name, 0.0) + (ge - gs) / 1e6
        idle_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], v] for n, v in device_ops],
                "idle_gaps": [[n[:200], v] for n, v in idle_gaps]}
