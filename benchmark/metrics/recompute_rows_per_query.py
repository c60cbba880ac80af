"""Rows the encoder ran a query in the profiled sub-window, chunk
padding included: the engine's traced `encoded_rows` over its
`traced_queries`, which the program adds to only while a profiler
records."""


def read(ctx, log):
    counts = ctx.get("recompute_counts") or {}
    if not counts.get("traced_queries"):
        log("recompute_rows_per_query: the program counted no query")
        return None
    log(f"the encoder ran {counts['encoded_rows']} rows ({counts['misses']} "
        f"distinct misses, {counts['hops']} hops) for "
        f"{counts['traced_queries']} traced queries")
    return counts["encoded_rows"] / counts["traced_queries"]
