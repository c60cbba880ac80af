"""The whole recompute search's share of the H100's dense bf16 peak, %:
the encoder's useful operations of the profiled sub-window (as
`encoder_mfu` counts them) over the wall seconds the run's thread spent
inside the program's span `recompute.search_many` there, times 989.4
TFLOP/s."""

from benchmark import spans
from benchmark.kernels import encoder_flops

OUTER = "recompute.search_many"


def read(ctx, log):
    counts, enc = ctx.get("recompute_counts") or {}, ctx.get("encoder")
    if spans.ms_per_batch(ctx, log, OUTER, OUTER) is None or enc is None \
            or not counts.get("misses"):
        return None
    prof, sp = ctx["profile"], spans.load(ctx, log)
    wall = sum(max(0.0, min(e, prof.end) - max(s, prof.start))
               for s, e in sp.intervals.get(OUTER, ()))
    if wall <= 0:
        return None
    flops = counts["misses"] * encoder_flops.row_flops(**enc)
    log(f"recompute: {flops / 1e12:.2f} TFLOP useful in {wall:.4f} wall s "
        f"inside {OUTER}")
    return 100.0 * flops / (wall * encoder_flops.H100_BF16_FLOPS)
