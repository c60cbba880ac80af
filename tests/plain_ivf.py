"""A plain IVF-Flat search for the CPU tests: plain torch in float32, one
query at a time, importing neither `leann_tpu` nor `leann_tpu_torch`.

The rule is the benchmark's (`benchmark/reference/ivf.py`), written
here again as loops so that each copy checks the other: the index's
centres and assignment are data; clusters go in order, each cluster's
rows in corpus order, `cap = max(8, ceil(1.3 n / K))` rows a bucket
unless the index sets its own, rows beyond cap spill into further
buckets with the same centre, and an empty cluster keeps one empty
bucket. A query probes the `nprobe` buckets whose centre scores highest,
ties to the lower bucket, and gets the exact float32 top-k of their rows
(ties to the lower id), -1 and -inf past their live rows. Scores are
"higher is better": l2 -> 2 q.x - |x|^2, ip -> q.x.
"""

from __future__ import annotations

import math

import torch


def bucket_list(assign, k: int, cap=None):
    """(cap, [(cluster, [row ids])]) in bucket order."""
    assign = [int(a) for a in assign]
    if cap is None:
        cap = max(8, math.ceil(1.3 * len(assign) / k))
    members = [[] for _ in range(k)]
    for row, c in enumerate(assign):
        members[c].append(row)
    out = []
    for c in range(k):
        rows = members[c]
        out.append((c, rows[:cap]))
        for s in range(cap, len(rows), cap):
            out.append((c, rows[s:s + cap]))
    return cap, out


def scores(q, x, metric: str):
    """[M] float32 scores of the rows `x` [M, D] for query `q` [D], each
    row's by the same sum, so that equal rows score equal."""
    x = torch.as_tensor(x).float()
    dots = (x * q.float()).sum(1)
    return 2 * dots - (x * x).sum(1) if metric == "l2" else dots


def probes(q, centers, blist, nprobe: int, metric: str):
    """The buckets query `q` probes, best first."""
    cs = scores(q, centers, metric).tolist()
    order = sorted(range(len(blist)), key=lambda b: (-cs[blist[b][0]], b))
    return order[:nprobe]


def search(queries, corpus, centers, assign, k: int, nprobe: int,
           metric: str, cap=None):
    """(ids [B, k] int64, scores [B, k] float32, live rows read)."""
    corpus = torch.as_tensor(corpus)
    _, blist = bucket_list(assign, len(centers), cap)
    ids = torch.full((len(queries), k), -1, dtype=torch.int64)
    top = torch.full((len(queries), k), -math.inf)
    live = 0
    for i, q in enumerate(torch.as_tensor(queries)):
        rows = [r for b in probes(q, centers, blist, nprobe, metric)
                for r in blist[b][1]]
        live += len(rows)
        sc = scores(q, corpus[rows], metric).tolist()
        best = sorted(zip((-v for v in sc), rows))[:k]
        for j, (s, r) in enumerate(best):
            ids[i, j], top[i, j] = r, -s
    return ids, top, live
