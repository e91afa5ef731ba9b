"""Per-layer metric readers, one module a metric, found by the metric's
name in BENCHMARK.json up to its first dot (``round_ms.field`` is read by
``round_ms.py``: the same quantity, reported apart for cells that move
another end-to-end metric). ``read(run)`` takes run.RunData and returns
the number, or None where the run holds nothing to read (the harness then
leaves the metric out of the result line)."""
