"""One reader per per-layer metric, found by the metric's name
(perfbench.metrics.<name>, a dot in the name read as "__"): read(ctx) gives
the value, or None where the run has nothing to read."""
