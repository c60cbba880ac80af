"""Device ms a batch launched inside the program's span
`fused_beam.seeds` (FusedBeamEngine's seed choice: the bf16 product over
the seed pool and its sort), in the profiled sub-window
(`benchmark/spans.py`)."""

from benchmark import spans


def read(ctx, log):
    return spans.ms_per_batch(ctx, log, "fused_beam.seeds",
                              "fused_beam.search_many")
