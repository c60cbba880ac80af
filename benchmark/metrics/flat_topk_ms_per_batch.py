"""Device ms a batch of the kernels whose names say top-k or sort, in
the profiled sub-window."""

import re

SELECT = re.compile(r"topk|sort", re.IGNORECASE)


def read(ctx, log):
    prof = ctx.get("profile")
    if prof is None or not ctx.get("batches"):
        return None
    secs = sum(t for name, t in prof.kernels() if SELECT.search(name))
    return secs * 1e3 / ctx["batches"] if secs > 0 else None
