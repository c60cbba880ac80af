"""Plain IVF-Flat search: the yardstick of the IVF cell's probing.

Plain PyTorch, float32 with TF32 off; imports nothing of the program.
The index's centres are data here, as a model's weights are. Its
assignment is checked before it is used (`check_assign`): every row's
best centre is found again in float64, and where the given centre does
not score within `TIE` of the best (on the score's scale) the best one
is taken. From that assignment the bucket list is rebuilt by the
documented rule: clusters in order, each cluster's rows in corpus
order, `cap = max(8, ceil(1.3 n / K))` rows a bucket (or the index's own
cap), rows beyond cap spilled into further buckets with the same
centre, and an empty cluster kept as one empty bucket. A query probes
the `nprobe` buckets whose centre scores highest, ties to the lower
bucket, and gets the exact float32 top-k of their rows. Scores are
"higher is better": l2 -> 2 q.x - |x|^2, ip -> q.x (`exact.py`'s
convention).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

from benchmark.reference.exact import no_tf32

# Two centre scores this close, over the score's scale (2|x||c| + |c|^2
# for l2, |x||c| for ip), are a tie within float32 rounding: a D = 128
# product's worst case is about 1.5e-5 of it, its typical error 1e-6.
TIE = 1e-5


def buckets(assign, k: int, cap: Optional[int] = None) -> Tuple:
    """(cap, cluster [K'] int64, rows [K', cap] int64, -1 where empty) of
    the bucket list of `assign` [n] over `k` clusters, on the CPU."""
    import torch

    a = torch.as_tensor(assign).to(device="cpu", dtype=torch.int64)
    n = a.numel()
    if cap is None:
        cap = max(8, math.ceil(1.3 * n / k))
    counts = torch.bincount(a, minlength=k)
    per = ((counts + cap - 1) // cap).clamp_min(1)       # buckets a cluster
    first = torch.cumsum(per, 0) - per                   # first bucket
    start = torch.cumsum(counts, 0) - counts             # first sorted row
    order = torch.sort(a, stable=True).indices           # corpus order
    rank = torch.arange(n) - start[a[order]]             # within cluster
    bucket = first[a[order]] + rank // cap
    rows = torch.full((int(per.sum()), cap), -1, dtype=torch.int64)
    rows[bucket, rank % cap] = order
    cluster = torch.repeat_interleave(torch.arange(k), per)
    return cap, cluster, rows


def scores(queries, vectors, metric: str):
    """[B, D] x [M, D] -> [B, M] float32 scores."""
    no_tf32()
    dots = queries.float() @ vectors.float().T
    if metric == "l2":
        return 2 * dots - (vectors.float() ** 2).sum(1)[None, :]
    return dots


def probe(queries, centers, cluster, nprobe: int, metric: str):
    """[B, nprobe] int64: the buckets (rows of `buckets`' list, whose
    centres are `centers[cluster]`) each query probes, best first, ties
    to the lower bucket."""
    import torch

    bucket_scores = scores(queries, centers, metric)[:, cluster]
    order = torch.sort(bucket_scores, dim=1, descending=True,
                       stable=True).indices
    return order[:, :nprobe]


def topk(queries, corpus, centers, assign, k: int, nprobe: int, metric: str,
         cap: Optional[int] = None, rows: int = 256) -> Tuple:
    """(ids [B, k] int64, scores [B, k] float32) on the corpus's device:
    the exact top-k of the rows of each query's probed buckets, -1 and
    -inf past their live rows; `rows` queries at a time."""
    import torch

    no_tf32()
    dev = corpus.device
    _, cluster, members = buckets(assign, len(centers), cap)
    cent = torch.as_tensor(centers, dtype=torch.float32).to(dev)
    cluster, members = cluster.to(dev), members.to(dev)
    ids, out = [], []
    for s in range(0, queries.shape[0], rows):
        q = queries[s:s + rows].to(device=dev, dtype=torch.float32)
        cand = members[probe(q, cent, cluster, nprobe, metric)]
        cand = cand.reshape(q.shape[0], -1)                  # [b, P * cap]
        x = corpus[cand.clamp_min(0)].float()                # [b, P*cap, D]
        sc = torch.einsum("bmd,bd->bm", x, q)
        if metric == "l2":
            sc = 2 * sc - (x * x).sum(2)
        sc = torch.where(cand >= 0, sc, -torch.inf)
        v, i = torch.topk(sc, min(k, sc.shape[1]), dim=1)
        got = torch.where(torch.isfinite(v), cand.gather(1, i), -1)
        ids.append(got)
        out.append(v)
    return torch.cat(ids), torch.cat(out)


def _scale(queries, centers, metric: str):
    """[B] float32: the scale of a query's centre scores, at the widest
    centre."""
    import torch

    qn = torch.linalg.vector_norm(queries.float(), dim=1)
    cn = float(torch.linalg.vector_norm(centers.float(), dim=1).max())
    return 2 * qn * cn + cn * cn if metric == "l2" else qn * cn


def live_rows_range(queries, centers, cluster, members, nprobe: int,
                    metric: str, tie: float = TIE) -> Tuple[int, int, int]:
    """(least, most, ambiguous): the live rows the queries' `nprobe`
    probes hold, summed over the queries. A query whose nprobe-th bucket's
    centre score lies within `tie` of its scale of another centre's score
    (a tie within rounding, which goes either way; `tie` 0 leaves only
    exact ties) is `ambiguous`: its probes may hold any of the buckets of
    those clusters after the ones that score higher. Every other query
    holds the rows of the buckets the rule picks (a cluster's buckets
    share its centre and come in order). `centers` [K] and `cluster`,
    `members` (`buckets`') on the queries' device."""
    import torch

    live = (members >= 0).sum(1)                          # [K']
    nprobe = min(nprobe, live.numel())
    sc = scores(queries, centers, metric)                 # [B, K]
    order = torch.sort(sc[:, cluster], dim=1, descending=True,
                       stable=True).indices[:, :nprobe]
    exact = live[order].sum(1)
    last = sc.gather(1, cluster[order[:, -1:]])
    band = (tie * _scale(queries, centers, metric))[:, None]
    near = (sc - last).abs() <= band                      # [B, K]
    ambiguous = near.sum(1) > 1
    sure = (sc > last + band)[:, cluster]                 # [B, K']
    near = near[:, cluster]
    base = (live * sure).sum(1)
    take = (nprobe - sure.sum(1))[:, None] - 1            # >= 0
    big = members.shape[1] + 1
    least = torch.where(near, live, big).sort(1).values.cumsum(1)
    most = torch.where(near, live, -1).sort(1, descending=True).values
    lo = torch.where(ambiguous, base + least.gather(1, take)[:, 0], exact)
    hi = torch.where(ambiguous,
                     base + most.cumsum(1).gather(1, take)[:, 0], exact)
    return int(lo.sum()), int(hi.sum()), int((lo != hi).sum())


def check_assign(rows, centers, assign, metric: str, tie: float = TIE,
                 chunk: int = 8192) -> Tuple[float, object]:
    """(gap, own): `gap` the widest amount, over the scale of the score's
    terms (2|x||c| + |c|^2 for l2, |x||c| for ip, at the assigned
    centre), by which a row's best centre outscores its assigned one, in
    float64; `own` [S] int64 on the CPU, the assignment the reference
    builds its buckets from: `assign` where its centre is within `tie`
    of the best, the best centre elsewhere. `rows` [S, D],
    `assign` [S] their assigned clusters."""
    import torch

    dev = rows.device
    c = torch.as_tensor(centers).to(device=dev, dtype=torch.float64)
    a = torch.as_tensor(assign).to(device=dev, dtype=torch.int64)
    cn = torch.linalg.vector_norm(c, dim=1)
    worst, own = 0.0, []
    for s in range(0, rows.shape[0], chunk):
        x, got_c = rows[s:s + chunk].double(), a[s:s + chunk]
        sc = x @ c.T
        scale = torch.linalg.vector_norm(x, dim=1) * cn[got_c]
        if metric == "l2":
            sc = 2 * sc - (cn * cn)[None, :]
            scale = 2 * scale + cn[got_c] ** 2
        best, best_c = sc.max(1)
        gap = (best - sc.gather(1, got_c[:, None])[:, 0]) / scale
        worst = max(worst, float(gap.max()))
        own.append(torch.where(gap <= tie, got_c, best_c).cpu())
    return worst, torch.cat(own)


def assign(rows, centers, metric: str, dtype=None, chunk: int = 65536):
    """[S] int64: each row's best centre, the scores in `dtype` (default
    float32), first centre on ties; `chunk` rows at a time."""
    import torch

    no_tf32()
    dtype = dtype or torch.float32
    c = torch.as_tensor(centers).to(device=rows.device, dtype=dtype)
    bias = (c.float() * c.float()).sum(1).to(dtype)[None, :]
    out = []
    for s in range(0, rows.shape[0], chunk):
        sc = rows[s:s + chunk].to(dtype) @ c.T
        if metric == "l2":
            sc = 2 * sc - bias
        out.append(sc.float().argmax(1))
    return torch.cat(out)
