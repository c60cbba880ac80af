"""The least time of one batch's IVF stage 1: the probed buckets' scan and
its running top-C, whatever implements them (the torch bucket scan that
`IvfEngine.search_many_device` runs, or kernel B4).

It counts what the batch's data needs: the live rows of each distinct
probed bucket read once (a bfloat16 vector of D, a float32 |v|^2 and an
int32 id each; a bucket's padding slots are not the search's data), the
queries read once (B x D float32), the [B, C] candidates written once (a
float32 score and an int64 id each); 2 x D operations a live row each
query probes. Peaks: one H100 SXM's published 3.35 TB/s of HBM3 and 67
TFLOP/s of float32 outside the tensor cores (`b1_bound.py`'s).
"""

from __future__ import annotations

from benchmark.kernels.b1_bound import H100_BYTES_PER_S, H100_FP32_FLOPS


def bound_ms(probe, live, d: int, c: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one batch whose queries
    probe the buckets `probe` [B, nprobe], bucket j holding `live[j]`
    rows of width `d`, keeping `c` candidates a query. With every
    bucket's `live` at its cap, it is the bound of a scan that reads the
    padding too."""
    import torch

    b = probe.shape[0]
    live = torch.as_tensor(live, device=probe.device)
    read = int(live[torch.unique(probe)].sum())
    scanned = int(live[probe].sum())
    bytes_ = read * (2 * d + 4 + 4) + b * d * 4 + b * c * (4 + 8)
    t_bytes = bytes_ / H100_BYTES_PER_S
    t_ops = 2 * scanned * d / H100_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")
