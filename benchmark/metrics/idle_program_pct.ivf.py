"""Share of the profiled sub-window, %, in which no device operation ran
while the run's thread was inside the program's span `ivf.search_many`
(`benchmark/spans.py`); the rest of `idle_pct.ivf` is the caller's."""

from benchmark import spans


def read(ctx, log):
    return spans.idle_program_pct(ctx, log, "ivf.search_many")
