"""Device ms a batch launched inside the program's span
`recompute.search_many` but outside `recompute.encode`: the traversal
around the encoder (entry choice, dedup, scoring, the beam's sorts and
masks, the visited-log merge), in the profiled sub-window
(`benchmark/spans.py`)."""

from benchmark import spans

OUTER = "recompute.search_many"


def read(ctx, log):
    whole = spans.ms_per_batch(ctx, log, OUTER, OUTER)
    encode = spans.ms_per_batch(ctx, log, "recompute.encode", OUTER)
    if whole is None or encode is None:
        return None
    return whole - encode
