"""The harness's own arithmetic: traffic, statistics, work counts, peaks,
weights, the profiler's trace, and the loop that runs a cell."""
