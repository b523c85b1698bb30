"""The device's idle share of the traced slice, in %."""

from benchmark.metrics._common import idle_pct as read  # noqa: F401
