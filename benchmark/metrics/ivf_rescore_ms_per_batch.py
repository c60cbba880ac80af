"""Device ms a batch launched inside the program's span `ivf.rescore`
(`IvfEngine._search`'s `_rescore_topk`, the float32 rescore of the C
candidates), in the profiled sub-window (`benchmark/spans.py`)."""

from benchmark import spans


def read(ctx, log):
    return spans.ms_per_batch(ctx, log, "ivf.rescore", "ivf.search_many")
