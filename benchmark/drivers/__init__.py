"""One module a driver: ``Cell(ctx)`` with ``setup``, ``window``,
``release`` and ``check`` (see ``benchmark/harness.py``)."""
