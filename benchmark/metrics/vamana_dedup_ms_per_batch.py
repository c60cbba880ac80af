"""Device ms a batch launched inside the program's span
`fused_beam.dedup` (FusedBeamEngine's int64 casts and the sort-dedup of
beam and visited log), in the profiled sub-window
(`benchmark/spans.py`)."""

from benchmark import spans


def read(ctx, log):
    return spans.ms_per_batch(ctx, log, "fused_beam.dedup",
                              "fused_beam.search_many")
