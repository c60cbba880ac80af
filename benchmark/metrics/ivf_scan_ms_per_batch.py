"""Device ms a batch launched inside the program's span `ivf.scan`
(`ivf_search`'s bucket gather, bf16 product, bias and sentinel masks,
every probe), in the profiled sub-window (`benchmark/spans.py`)."""

from benchmark import spans


def read(ctx, log):
    return spans.ms_per_batch(ctx, log, "ivf.scan", "ivf.search_many")
