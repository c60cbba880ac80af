"""Share of the profiled sub-window in which no device operation ran, %,
in a recompute cell (`benchmark.profiling.idle_pct`)."""

from benchmark.profiling import idle_pct as read  # noqa: F401
