"""The encoder's share of the H100's dense bf16 peak while it runs, %:
the useful operations of the profiled sub-window (the engine's traced
`misses`, the distinct rows re-embedded, times one row's operations at
the stored token width, `benchmark/kernels/encoder_flops.py`) over the
device time under the program's span `recompute.encode` times 989.4
TFLOP/s. The rows encoded as chunk padding are logged beside it."""

from benchmark import spans
from benchmark.kernels import encoder_flops


def read(ctx, log):
    counts, enc = ctx.get("recompute_counts") or {}, ctx.get("encoder")
    ms = spans.ms_per_batch(ctx, log, "recompute.encode",
                            "recompute.search_many")
    if ms is None or enc is None or not counts.get("misses"):
        return None
    flops = counts["misses"] * encoder_flops.row_flops(**enc)
    seconds = ms * ctx["batches"] / 1e3
    log(f"encoder: {counts['misses']} useful rows and "
        f"{counts['encoded_rows'] - counts['misses']} padding rows in "
        f"{seconds:.4f} device s, {flops / seconds / 1e12:.1f} TFLOP/s")
    return 100.0 * flops / (seconds * encoder_flops.H100_BF16_FLOPS)
