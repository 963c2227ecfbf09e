"""CPU tests of the benchmark harness (run: python -m pytest perfbench/tests);
tests marked `cuda` need the card and skip elsewhere."""
