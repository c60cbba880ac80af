"""Nodes kernel B1 expanded a query in the profiled sub-window: the
device-side total `fused_beam_search.expansions` over
`fused_beam_search.traced_queries`, which the wrapper adds to only while
a profiler records (each CTA counts its query's expansions)."""


def read(ctx, log):
    search = ctx.get("b1_search")
    total = getattr(search, "expansions", None)
    rows = getattr(search, "traced_queries", 0)
    if total is None or not rows:
        log("b1_expansions_per_query: the program counts no B1 expansions")
        return None
    total = int(total)
    log(f"B1 expanded {total} nodes for {rows} traced queries")
    return total / rows
