"""Device ms a batch launched inside the program's span `exact.stage1`
(ExactEngine's bf16 product with a float32 result, its scale and bias),
in the profiled sub-window (`benchmark/spans.py`)."""

from benchmark import spans


def read(ctx, log):
    return spans.ms_per_batch(ctx, log, "exact.stage1", "exact.search_many")
