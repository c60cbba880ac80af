"""The bench corpus pool with an on-disk cache (the port's copy of
`make_corpus` and `get_pool` in the reference's `evals/corpus_cache.py`).

Every bench draws the same deterministic mixture-of-gaussians pool: one
PCG64 stream seeded 0, pool size n + extra (1024 + 2048 by default). The
draw count is the contract: changing it shifts the stream and silently
mismatches prebuilt graph artifacts, which either package may have
written. The pool equals the reference's bit for bit. For n >= 1M it
persists as a raw .npy memmap in `ART_DIR` (git-ignored), beside the
bench's graph and PQ artifacts.
"""

from __future__ import annotations

import os

import numpy as np

ART_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_artifacts")


def make_corpus(rng, n, d, clusters=1024, chunk=1 << 20):
    """`clusters` centers at 4x unit normal plus unit noise. The noise is
    drawn in row chunks: the same stream as one draw, without a float64
    temporary of the whole corpus (7.7 GB at 10M x 96)."""
    centers = rng.standard_normal((clusters, d)).astype(np.float32) * 4.0
    assign = rng.integers(0, clusters, n)
    out = np.empty((n, d), np.float32)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        out[s:e] = centers[assign[s:e]] + rng.standard_normal(
            (e - s, d)).astype(np.float32)
    return out


def pool_path(n: int, d: int, clusters: int = 1024, seed: int = 0) -> str:
    return os.path.join(ART_DIR, f"pool_n{n}_d{d}_c{clusters}_s{seed}.npy")


def get_pool(n: int, d: int, extra: int = 1024 + 2048,
             clusters: int = 1024, seed: int = 0) -> np.ndarray:
    """The bench pool [n + extra, d]: corpus rows first, then recall
    queries, then the (legacy) batch slice. Cached for n >= 1M."""
    path = pool_path(n, d, clusters, seed)
    if os.path.exists(path):
        return np.lib.format.open_memmap(path, mode="r")
    pool = make_corpus(np.random.default_rng(seed), n + extra, d, clusters)
    if n >= 1_000_000:
        os.makedirs(ART_DIR, exist_ok=True)
        tmp = path + ".tmp.npy"
        np.save(tmp, pool)
        os.replace(tmp, path)
        return np.lib.format.open_memmap(path, mode="r")
    return pool
