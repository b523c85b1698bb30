"""One file a per-layer metric, named as the metric: ``read(reading)``."""
