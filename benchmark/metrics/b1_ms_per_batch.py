"""Kernel B1's device ms a batch in the profiled sub-window."""

from benchmark.kernels import b1_time


def read(ctx, log):
    return b1_time.ms_per_batch(ctx, log)
