"""Device ms a batch launched inside the program's span `exact.rescore`
(ExactEngine's float32 rescore of the top-c: row gather, product, sort),
in the profiled sub-window (`benchmark/spans.py`)."""

from benchmark import spans


def read(ctx, log):
    return spans.ms_per_batch(ctx, log, "exact.rescore", "exact.search_many")
