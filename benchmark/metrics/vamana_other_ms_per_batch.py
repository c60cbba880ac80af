"""Device ms a batch of the kernels other than B1 in the profiled
sub-window: the engine's query preparation and seed choice, the float32
rescore of the beam and visited log, and its sort."""

from benchmark.kernels import b1_time


def read(ctx, log):
    prof = ctx.get("profile")
    if prof is None or not ctx.get("batches"):
        return None
    secs = sum(t for name, t in prof.kernels()
               if not any(k in name for k in b1_time.KERNELS))
    return secs * 1e3 / ctx["batches"]
