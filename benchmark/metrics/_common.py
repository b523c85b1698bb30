"""What the per-layer readers share.  Each reader returns None where the
run gave it nothing to read, and the harness then leaves the metric out."""

from __future__ import annotations


def idle_pct(reading):
    """The device's idle share of the traced slice, in %: 1 - the union of
    its kernel, copy and set intervals over the slice's wall span."""
    t = reading.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def is_copy(name: str) -> bool:
    """A copy on the device: a memcpy, or a kernel of ``aten::copy_``."""
    return name.startswith("Memcpy") or "copy" in name.lower()


def is_port_kernel(name: str) -> bool:
    """One of the program's own per-op kernels."""
    return "qgemm" in name or "qdwconv" in name
