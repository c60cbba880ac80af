"""Live bucket rows the IVF scan read a query in the profiled sub-window:
the device-side total `ivf_search.rows` over `ivf_search.traced_queries`,
which `ivf_search` adds to only while a profiler records (the
non-sentinel rows of each query's probed buckets)."""


def read(ctx, log):
    search = ctx.get("ivf_search")
    total = getattr(search, "rows", None)
    queries = getattr(search, "traced_queries", 0)
    if total is None or not queries:
        log("ivf_rows_per_query: the program counts no IVF rows")
        return None
    total = int(total)
    log(f"the IVF scan read {total} live rows for {queries} traced queries")
    return total / queries
