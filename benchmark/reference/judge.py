"""The numbers that decide `correct`, each held against its limit.

Batch cells (ids and scores of the window's queries, a sample drawn
from the seed):
  bad_rows   rows with an id out of range or twice, a score that is not
             finite, or scores not in descending order (limit 0)
  score_err  the widest gap between a returned score and the float64
             score of its id, over the scale of the score's terms
  rank_gap   (exact engines) the widest amount by which an exact top-k
             id left out scores above the row's lowest, on that scale
  recall_shortfall
             1 - recall@k over every query of the window, against the
             exact top-k (`hits`): what the search found, where the
             other numbers judge only how it scored and ordered it

`correct` holds where every number is within its limit.
"""

from __future__ import annotations

from typing import Dict

from benchmark.reference import exact


def batch_numbers(queries, ids, scores, corpus, metric: str,
                  ranked: bool) -> Dict[str, float]:
    """`queries` [S, D], the program's `ids` [S, k] and `scores` [S, k]
    for them, the `corpus` they index (all torch tensors)."""
    import torch

    n = corpus.shape[0]
    ids = ids.to(torch.int64)
    k = ids.shape[1]
    valid = (ids >= 0) & (ids < n)
    srt, _ = torch.sort(ids.clamp(-1, n), dim=1)
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    sc = scores.double()
    finite = torch.isfinite(sc).all(1)
    ordered = (sc[:, 1:] <= sc[:, :-1]).all(1) if k > 1 else finite
    bad = (~valid.all(1)) | dup | ~finite | ~ordered
    ref, scale = exact.scores_of(queries, corpus, ids.clamp(0, n - 1),
                                 metric)
    gap = ((sc.to(ref.device) - ref).abs() / scale)
    gap = torch.where(valid.to(gap.device) & torch.isfinite(gap), gap,
                      torch.ones_like(gap))
    out = {"bad_rows": float(bad.sum()),
           "score_err": float(gap.max()) if gap.numel() else 0.0}
    if ranked:
        t_ids, _ = exact.topk(queries, corpus, k, metric)
        t_sc, t_scale = exact.scores_of(queries, corpus, t_ids, metric)
        low = torch.where(valid.to(ref.device), ref,
                          torch.full_like(ref, float("inf"))).min(1).values
        missing = ~(t_ids[:, :, None].to(ids.device)
                    == ids[:, None, :]).any(2).to(t_sc.device)
        miss = ((t_sc - low[:, None]) / t_scale).clamp_min(0)
        out["rank_gap"] = float(torch.where(missing, miss,
                                            torch.zeros_like(miss)).max())
    return out


def hits(got, ref) -> int:
    """Sum over the rows of `got` and `ref` [Q, k] of |got & ref|."""
    return int((got[:, :, None] == ref[:, None, :]).any(1).sum())


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, lines): every limited number within its limit; one
    `name number <= limit` line each."""
    ok = True
    lines = []
    for name in sorted(limits):
        value = numbers.get(name)
        good = value is not None and value <= limits[name]
        ok = ok and good
        lines.append(f"{name} {value!r} <= {limits[name]!r}"
                     f"{'' if good else '  FAILED'}")
    return ok, lines
