"""The IVF stage 1's share of its roofline, %: the least time one batch's
bucket scan and running top-C need (`benchmark/kernels/ivf_scan_bound.py`:
the live rows of the probed buckets, over each batch of the first query
group's probes) over the device ms a batch under the program's spans
`ivf.scan` and `ivf.merge`. The bound of a scan that reads the buckets'
padding too is logged beside it."""

from benchmark import spans
from benchmark.kernels import ivf_scan_bound


def read(ctx, log):
    scan = spans.ms_per_batch(ctx, log, "ivf.scan", "ivf.search_many")
    merge = spans.ms_per_batch(ctx, log, "ivf.merge", "ivf.search_many")
    if scan is None or merge is None or not ctx.get("ivf_probes"):
        return None
    live, padded = ctx["ivf_live"], ctx["ivf_live"].clone()
    padded[:] = ctx["ivf_cap"]

    def mean(rows):
        bounds = [ivf_scan_bound.bound_ms(p, rows, ctx["d"],
                                          ctx["ivf_candidates"])
                  for p in ctx["ivf_probes"]]
        return sum(b[0] for b in bounds) / len(bounds), bounds[0][1]

    (bound, by), (pad, _) = mean(live), mean(padded)
    log(f"IVF stage-1 bound {bound:.4f} ms a batch (by {by}; "
        f"{pad:.4f} counting the padding), scan {scan:.4f} + merge "
        f"{merge:.4f} ms profiled")
    return 100.0 * bound / (scan + merge)
