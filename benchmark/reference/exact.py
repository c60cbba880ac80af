"""Plain exact search: the yardstick of the batch cells.

Plain PyTorch with TF32 off. Scores are "higher is better" in the
program's convention: l2 -> 2 q.x - |x|^2 (|q - x|^2 less the constant
|q|^2), ip -> q.x. Imports nothing of the program.
"""

from __future__ import annotations

from typing import Tuple


def no_tf32() -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def topk(queries, corpus, k: int, metric: str, rows: int = 2048,
         dtype=None) -> Tuple:
    """(ids [B, k] int64, scores [B, k]) of the exact top-k of every
    query, the product in `dtype` (default float32) on the corpus's
    device, `rows` queries at a time."""
    import torch

    no_tf32()
    dtype = dtype or torch.float32
    c = corpus.to(dtype)
    sq = (c.float() * c.float()).sum(1).to(dtype) if metric == "l2" else None
    ids, scores = [], []
    for s in range(0, queries.shape[0], rows):
        q = queries[s:s + rows].to(device=corpus.device, dtype=dtype)
        sc = q @ c.T
        if metric == "l2":
            sc = 2 * sc - sq[None, :]
        v, i = torch.topk(sc, k, dim=1)
        ids.append(i)
        scores.append(v)
    return torch.cat(ids), torch.cat(scores)


def scores_of(queries, corpus, ids, metric: str):
    """float64 [B, k] scores of `ids` [B, k] (rows of `corpus`) for each
    query, and the scale each is measured against: 2|q||x| + |x|^2 for
    l2, |q||x| for ip (what the terms of the score can add up to)."""
    import torch

    q = queries.to(device=corpus.device, dtype=torch.float64)
    x = corpus[ids.to(corpus.device)].to(torch.float64)       # [B, k, D]
    dots = torch.einsum("bkd,bd->bk", x, q)
    qn = torch.linalg.vector_norm(q, dim=1)[:, None]
    xn = torch.linalg.vector_norm(x, dim=2)
    if metric == "l2":
        return 2 * dots - xn * xn, 2 * qn * xn + xn * xn
    return dots, qn * xn
