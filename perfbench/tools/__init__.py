"""Tools that read the cells' checks over many seeds, with the control and
the planted faults; they are not part of a benchmark run."""
