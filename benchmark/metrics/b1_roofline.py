"""Kernel B1's share of its roofline, %: the least time one call needs
(`benchmark/kernels/b1_bound.py`, the batches of one query group, each
rerun with a full visited log to count its expansions) over B1's
profiled time a batch."""

from benchmark.kernels import b1_bound, b1_time


def read(ctx, log):
    ms = b1_time.ms_per_batch(ctx, log)
    if ms is None or not ctx.get("b1_calls"):
        return None
    bounds = [b1_bound.bound_ms(kw, ctx["b1_search"])
              for kw in ctx["b1_calls"]]
    bound = sum(b[0] for b in bounds) / len(bounds)
    log(f"B1 bound {bound:.4f} ms a batch (by {bounds[0][1]}; expansions "
        f"{[b[2] for b in bounds]}), profiled {ms:.4f} ms")
    return 100.0 * bound / ms
