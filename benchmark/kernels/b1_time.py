"""Kernel B1's time in a profiled sub-window, checked against its
wrapper's launch counter.

One call of `fused_beam_search` launches `fused_beam_kernel` (a CTA per
query) and then `fused_settle_kernel`; its time is the two together.
Where the profile's count of `fused_beam_kernel` differs from the
launches `fused_beam_search.launches` counted over the same sub-window,
the profile missed or added some, and no B1 number is read.
"""

from __future__ import annotations

from typing import Optional

KERNELS = ("fused_beam_kernel", "fused_settle_kernel")


def ms_per_batch(ctx, log) -> Optional[float]:
    prof = ctx.get("profile")
    if prof is None or not ctx.get("batches"):
        return None
    kernels = prof.kernels()
    seen = sum(1 for name, _ in kernels if KERNELS[0] in name)
    if seen != ctx.get("b1_launches"):
        log(f"B1: the profile holds {seen} launches of {KERNELS[0]}, the "
            f"wrapper counted {ctx.get('b1_launches')}: no B1 metric")
        return None
    if seen != ctx["batches"]:
        log(f"B1: {seen} launches for {ctx['batches']} batches: no B1 "
            "metric")
        return None
    secs = sum(t for name, t in kernels if any(k in name for k in KERNELS))
    return secs * 1e3 / ctx["batches"]
