"""Share of the profiled sub-window, %, in which no device operation ran
while the run's thread was inside the program's span
`recompute.search_many` (`benchmark/spans.py`); the rest of
`idle_pct.recompute` is the caller's (the query embedding, the copies)."""

from benchmark import spans


def read(ctx, log):
    return spans.idle_program_pct(ctx, log, "recompute.search_many")
