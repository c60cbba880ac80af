"""Device ms a batch launched inside the program's span
`recompute.encode` (each hop's encoder forwards and cache writes), in
the profiled sub-window (`benchmark/spans.py`)."""

from benchmark import spans


def read(ctx, log):
    return spans.ms_per_batch(ctx, log, "recompute.encode",
                              "recompute.search_many")
