"""Device ms a batch launched inside the program's span `ivf.probe`
(`ivf_search`'s centroid scores and top-nprobe), in the profiled
sub-window (`benchmark/spans.py`)."""

from benchmark import spans


def read(ctx, log):
    return spans.ms_per_batch(ctx, log, "ivf.probe", "ivf.search_many")
