"""Device ms a batch launched inside the program's span `ivf.merge`
(`ivf_search`'s running top-C, every probe: `cat`, `topk_stable`,
`gather`), in the profiled sub-window (`benchmark/spans.py`)."""

from benchmark import spans


def read(ctx, log):
    return spans.ms_per_batch(ctx, log, "ivf.merge", "ivf.search_many")
