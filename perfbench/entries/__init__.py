"""One driver per entry kind; a cell's file names its kind, and the harness
imports perfbench.entries.<kind>."""
