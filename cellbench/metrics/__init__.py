"""Metric readers, one file a metric, named as the metric is in
BENCHMARK.json (``<name>.py``).  ``read(rec)`` takes the run's
``cellbench.harness.Record`` and returns the value, or None where the run
holds nothing to read."""
