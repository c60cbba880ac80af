"""Device ms a batch launched inside the program's span
`fused_beam.rescore` (FusedBeamEngine's float32 rescore of the deduped
candidates: row gather, product, sort), in the profiled sub-window
(`benchmark/spans.py`)."""

from benchmark import spans


def read(ctx, log):
    return spans.ms_per_batch(ctx, log, "fused_beam.rescore",
                              "fused_beam.search_many")
