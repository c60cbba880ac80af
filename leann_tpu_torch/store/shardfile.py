"""Per-shard ANN artifacts on disk (`<base>.shards.npz`), a copy of
`leann_tpu/store/shardfile.py`: the same keys and dtypes, so a file
written by either package loads in the other.

Sharded serving (parallel/sharded.py) partitions the corpus row-wise
across the device mesh and builds a per-shard structure: a Vamana
subgraph per shard, or per-shard k-means centroids+assignments for IVF.
Building those is the expensive step — this sidecar persists them so a
sharded index is built once and reloaded by every later sharded load
(`backend.ShardedSearcher`).

Layout notes: arrays are stacked per shard. The file records the shard
count it was built for — loading under a mesh with a different shard
count returns None (caller rebuilds for the new topology and re-saves).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def shards_path(base: str) -> str:
    return base + ".shards.npz"


def save_graph_shards(
    base: str,
    adjacency_shards: np.ndarray,  # [s, rows, R] int32 (local ids; pad=rows)
    medoids: np.ndarray,           # [s] int32
    n: int,
    metric: str,
) -> str:
    path = shards_path(base)
    np.savez_compressed(
        path,
        kind="graph",
        n_shards=np.int32(adjacency_shards.shape[0]),
        n=np.int64(n),
        metric=str(metric),
        adjacency=adjacency_shards.astype(np.int32),
        medoids=np.asarray(medoids, np.int32),
    )
    return path


def save_ivf_shards(
    base: str,
    centers: List[np.ndarray],  # per shard [K_s, D] f32 (K_s may differ)
    assign: List[np.ndarray],   # per shard [valid_s] int32
    n: int,
    metric: str,
) -> str:
    s = len(centers)
    d = centers[0].shape[1]
    kp = max(c.shape[0] for c in centers)
    rows = max(a.shape[0] for a in assign)
    cent_st = np.zeros((s, kp, d), np.float32)
    k_per = np.zeros(s, np.int32)
    assign_st = np.full((s, rows), -1, np.int32)
    valid = np.zeros(s, np.int32)
    for i, (c, a) in enumerate(zip(centers, assign)):
        cent_st[i, : c.shape[0]] = c
        k_per[i] = c.shape[0]
        assign_st[i, : a.shape[0]] = a
        valid[i] = a.shape[0]
    path = shards_path(base)
    np.savez_compressed(
        path,
        kind="ivf",
        n_shards=np.int32(s),
        n=np.int64(n),
        metric=str(metric),
        centers=cent_st,
        k_per_shard=k_per,
        assign=assign_st,
        valid_per_shard=valid,
    )
    return path


def invalidate_shards(base: str) -> None:
    """Delete the per-shard sidecar (called when the index is rebuilt:
    a stale sidecar at the same base would silently serve the old
    corpus's graph/k-means)."""
    path = shards_path(base)
    if os.path.exists(path):
        os.remove(path)


def load_shards(
    base: str,
    n_shards: int,
    n: Optional[int] = None,
    metric: Optional[str] = None,
) -> Optional[dict]:
    """Returns the artifact dict when present AND built for `n_shards`
    shards (and, when given, the same corpus size `n` and `metric`);
    None otherwise (caller rebuilds)."""
    path = shards_path(base)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if int(z["n_shards"]) != int(n_shards):
            return None
        if n is not None and int(z["n"]) != int(n):
            return None
        if metric is not None and str(z["metric"]) != str(metric):
            return None
        out = {k: z[k] for k in z.files}
    out["kind"] = str(out["kind"])
    out["metric"] = str(out["metric"])
    if out["kind"] == "ivf":
        centers, assign = [], []
        for s in range(int(out["n_shards"])):
            centers.append(out["centers"][s, : int(out["k_per_shard"][s])])
            assign.append(out["assign"][s, : int(out["valid_per_shard"][s])])
        out["centers_list"] = centers
        out["assign_list"] = assign
    return out
