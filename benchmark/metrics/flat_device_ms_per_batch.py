"""Device busy ms a batch in the profiled sub-window (every kernel, copy
and set; overlaps counted once)."""


def read(ctx, log):
    prof = ctx.get("profile")
    if prof is None or not ctx.get("batches"):
        return None
    return prof.busy_s() * 1e3 / ctx["batches"]
