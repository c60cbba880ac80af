"""The least time one call of kernel B1 (`fused_beam_search`) needs.

A frozen copy of `chip_smoke.py:kernel_bound`'s arithmetic. It counts
what the call's data needs: each expanded record's R live lanes read
once (R*D int8 plus ids, scales and |v|^2, 3*R*4 bytes), the queries,
seeds and exclude list read once, the beam's ids and scores and the
visited log written once; 2*R*D float32 operations per expansion. The
expansions are counted by running the call again with a visited log
long enough for every hop. Peaks: one H100 SXM's published 3.35 TB/s
of HBM3 and 67 TFLOP/s of float32 outside the tensor cores.
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12


def bound_ms(kw: dict, search) -> tuple:
    """(bound ms, "bytes" or "operations", expansions) of one call with
    arguments `kw`; `search` is the kernel's wrapper, rerun with a full
    visited log to count the expansions."""
    e = kw["expansions"]
    vlog = search(**dict(kw, track_visited=kw["max_iters"] * e))[2]
    expansions = int((vlog != kw["blocks_i8"].shape[0] - 1).sum())
    b, d = kw["queries"].shape
    r, s = kw["r"], kw["seed_ids"].shape[1]
    vt = -(-kw["track_visited"] // 128) * 128
    bytes_ = (expansions * (r * d + 3 * r * 4) + b * (d * 4 + s * 8 + 4)
              + b * (kw["beam_width"] * 8 + vt * 4))
    t_bytes = bytes_ / H100_BYTES_PER_S
    t_ops = 2 * expansions * r * d / H100_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", expansions)
