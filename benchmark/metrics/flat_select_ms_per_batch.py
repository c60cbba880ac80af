"""Device ms a batch launched inside the program's span `exact.select`
(ExactEngine's top-c of each query chunk's stage-1 scores), in the
profiled sub-window (`benchmark/spans.py`)."""

from benchmark import spans


def read(ctx, log):
    return spans.ms_per_batch(ctx, log, "exact.select", "exact.search_many")
