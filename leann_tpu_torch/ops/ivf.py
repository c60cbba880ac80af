"""IVF (inverted-file) index: k-means partitioning + dense bucket scoring
(port of `leann_tpu/ops/ivf.py`).

Search is three steps of matrix-shaped work:

    1. score all centroids:      Q @ C.T              one GEMM
    2. pick top-nprobe clusters per query              one top-k
    3. scan the nprobe probed buckets; each step gathers a [B, cap, D]
       block of bf16 bucket vectors and scores it as a batched product,
       merging a running top-C; the C survivors are rescored in f32

Step 3 is plain PyTorch in `ivf_search` (`IvfEngine.search`, what
`IvfSearcher` serves; the reference left it to XLA outside any kernel).
`IvfEngine.search_pallas` runs the same scan through kernel B4
(`ops/bucket_kernels.py`, CUDA on the card). The build is k-means on the
device.

Bucket layout: vectors are re-packed into [K', cap, D] padded buckets
(cap ~= 1.3 x mean occupancy); rows beyond cap spill into extra buckets
that share the parent centroid, so nothing is dropped and the top-nprobe
centroid scoring probes them (a duplicated centroid scores identically).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from leann_tpu_torch.device import DeviceLike, resolve_device
from leann_tpu_torch.ops.distance import (
    NEG_INF, _rescore_topk, pairwise_scores, topk_stable,
)


# ---------------------------------------------------------------- k-means


def _assign_chunked(vectors, centers, metric, chunk) -> torch.Tensor:
    """[N] nearest center per row (argmax of the scores, first index on
    ties), in row chunks."""
    return torch.cat([
        pairwise_scores(vectors[s : s + chunk], centers, metric).argmax(1)
        for s in range(0, vectors.shape[0], chunk)])


def _kmeans_update(v_dev, assign, centers_prev, k: int) -> torch.Tensor:
    d = v_dev.shape[1]
    sums = torch.zeros((k, d), dtype=torch.float32, device=v_dev.device)
    sums.index_add_(0, assign, v_dev)
    counts = torch.zeros((k,), dtype=torch.float32, device=v_dev.device)
    counts.index_add_(0, assign, torch.ones_like(assign, dtype=torch.float32))
    fresh = sums / counts.clamp_min(1.0)[:, None]
    return torch.where((counts > 0)[:, None], fresh, centers_prev)


def kmeans(
    vectors: np.ndarray,
    k: int,
    iters: int = 8,
    metric: str = "l2",
    seed: int = 0,
    chunk: int = 65536,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd's algorithm on `device`. Returns (centers [K, D] f32,
    assign [N] int32); the initial centers are the reference's numpy
    draw."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n, _ = vectors.shape
    chunk = min(chunk, 1 << max(8, (n - 1).bit_length()))
    v_host = np.ascontiguousarray(vectors, dtype=np.float32)
    v_dev = torch.from_numpy(v_host).to(dev)
    centers = torch.from_numpy(
        v_host[rng.choice(n, size=k, replace=n < k)]).to(dev)
    for _ in range(iters):
        assign = _assign_chunked(v_dev, centers, metric, chunk)
        centers = _kmeans_update(v_dev, assign, centers, k)
    assign = _assign_chunked(v_dev, centers, metric, chunk)
    return (centers.cpu().numpy(),
            assign.to(torch.int32).cpu().numpy())


# ---------------------------------------------------------------- packing


def bucket_rows(assign: np.ndarray, k: int, n: int, cap: Optional[int]):
    """(cap, [(cluster, row ids)]) of the padded bucket layout that every
    IVF engine packs: cap defaults to 1.3 x the mean occupancy (at least
    8), a cluster's rows keep their corpus order, rows beyond cap spill
    into further buckets of the same cluster, and an empty cluster keeps
    one empty bucket."""
    counts = np.bincount(assign, minlength=k)
    if cap is None:
        cap = max(8, int(np.ceil(1.3 * n / k)))
    order = np.argsort(assign, kind="stable")
    starts = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    rows = []
    for c in range(k):
        ids = order[starts[c]:starts[c + 1]]
        for off in range(0, max(len(ids), 1), cap):
            part = ids[off : off + cap]
            if len(part) == 0 and off > 0:
                break
            rows.append((c, part))
    return cap, rows


def pack_buckets(
    vectors: np.ndarray,
    assign: np.ndarray,
    centers: np.ndarray,
    cap: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (bucket_ids [K', cap], bucket_centroids [K', D],
    bucket_vecs [K', cap, D]). K' >= K because overflow rows become
    additional buckets sharing the parent centroid."""
    n, d = vectors.shape
    cap, bucket_rows_ = bucket_rows(assign, centers.shape[0], n, cap)
    kp = len(bucket_rows_)
    bucket_ids = np.full((kp, cap), n, dtype=np.int32)   # sentinel = n
    bucket_cent = np.zeros((kp, d), dtype=np.float32)
    bucket_vecs = np.zeros((kp, cap, d), dtype=np.float32)
    for row, (c, ids) in enumerate(bucket_rows_):
        bucket_ids[row, : len(ids)] = ids
        bucket_cent[row] = centers[c]
        if len(ids):
            bucket_vecs[row, : len(ids)] = vectors[ids]
    return bucket_ids, bucket_cent, bucket_vecs


# ---------------------------------------------------------------- search


def device_queries(queries, device, metric_in) -> torch.Tensor:
    """[B, D] f32 queries on `device`, normalized for cosine engines."""
    q = torch.as_tensor(queries, dtype=torch.float32, device=device)
    if q.dim() == 1:
        q = q[None, :]
    if metric_in == "cosine":
        q = q / (torch.linalg.vector_norm(q, dim=1, keepdim=True) + 1e-12)
    return q


def search_sizes(engine, k, nprobe, rescore_factor) -> Tuple[int, int, int]:
    """(k, nprobe, candidates to rescore) of an IVF engine's search,
    clamped to its corpus and bucket counts."""
    nprobe = min(nprobe, engine.bucket_cent.shape[0])
    k = min(k, engine.n)
    return k, nprobe, min(max(rescore_factor * k, k), engine.n)


class IvfEngine:
    """bf16 bucket scan + f32 rescore against the resident corpus, on
    `device` (default cuda)."""

    def __init__(
        self,
        vectors: np.ndarray,
        n_clusters: Optional[int] = None,
        metric: str = "ip",
        kmeans_iters: int = 8,
        cap: Optional[int] = None,
        seed: int = 0,
        centers: Optional[np.ndarray] = None,
        assign: Optional[np.ndarray] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.metric_in = metric
        if metric == "cosine":
            vectors = vectors / (
                np.linalg.norm(vectors, axis=1, keepdims=True) + 1e-12
            )
            metric = "ip"
        self.metric = metric
        self.n, self.d = vectors.shape
        if n_clusters is None:
            n_clusters = max(16, int(np.sqrt(self.n) * 2))
        self.n_clusters = min(n_clusters, self.n)

        if centers is None or assign is None:
            centers, assign = kmeans(
                vectors, self.n_clusters, iters=kmeans_iters,
                metric=self.metric, seed=seed, device=self.device,
            )
        bucket_ids, bucket_cent, bucket_vecs = pack_buckets(
            vectors, assign, centers, cap=cap
        )
        dev = self.device
        self.centers = centers
        self.assign = assign
        self.cap = bucket_ids.shape[1]
        self.bucket_ids = torch.from_numpy(bucket_ids).to(dev)
        self.bucket_cent = torch.from_numpy(bucket_cent).to(dev)
        # bucket vectors live only as bf16 (the scan type); exact scores
        # come from the f32 corpus at rescore time. |v|^2 is summed on the
        # host, as the reference does (the same bits).
        self.bucket_vecs_bf16 = torch.from_numpy(bucket_vecs).to(dev).to(
            torch.bfloat16)
        self.bucket_sq = torch.from_numpy(
            (bucket_vecs * bucket_vecs).sum(axis=2)).to(dev)
        del bucket_vecs
        self._corpus_dev = torch.from_numpy(vectors).to(dev)

    def search_pallas(
        self, queries, k: int = 10, nprobe: int = 32,
        rescore_factor: int = 4,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Kernel path: the probed buckets are scored by kernel B4
        (`ivf_bucket_dots`, CUDA on the card) instead of a gathered
        batched product; results rescored in f32. Returns numpy (ids,
        scores)."""
        ids, scores = self.search_pallas_device(
            queries, k=k, nprobe=nprobe, rescore_factor=rescore_factor)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def search_pallas_device(
        self, queries, k: int = 10, nprobe: int = 32,
        rescore_factor: int = 4,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`search_pallas` without the host copy: (ids, scores) on the
        device. The reference pads cap to a multiple of 128 for its TPU
        tiling; the CUDA kernel takes the engine's own tables."""
        from leann_tpu_torch.ops.bucket_kernels import ivf_search_pallas

        q = device_queries(queries, self.device, self.metric_in)
        k, nprobe, c = search_sizes(self, k, nprobe, rescore_factor)
        _, cand = ivf_search_pallas(
            q, self.bucket_cent, self.bucket_ids, self.bucket_vecs_bf16,
            self.bucket_sq, k=c, nprobe=nprobe, metric=self.metric,
            sentinel=self.n)
        scores, ids = _rescore_topk(q, self._corpus_dev, cand, k, self.metric)
        return ids, scores

    def search(
        self, queries, k: int = 10, nprobe: int = 32,
        rescore_factor: int = 4,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Buckets are scanned in bf16 (f32 accumulation); the
        rescore_factor*k survivors are rescored at full f32 against the
        resident corpus. Returns numpy (ids, scores)."""
        ids, scores = self.search_device(
            queries, k=k, nprobe=nprobe, rescore_factor=rescore_factor)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def search_device(
        self, queries, k: int = 10, nprobe: int = 32,
        rescore_factor: int = 4,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-out search: (ids, scores) on the device."""
        q = device_queries(queries, self.device, self.metric_in)
        k, nprobe, c = search_sizes(self, k, nprobe, rescore_factor)
        _, cand = ivf_search(
            q, self.bucket_cent, self.bucket_ids, self.bucket_vecs_bf16,
            self.bucket_sq, k=c, nprobe=nprobe, metric=self.metric,
            sentinel=self.n,
        )
        scores, ids = _rescore_topk(q, self._corpus_dev, cand, k, self.metric)
        return ids, scores

    def search_many_device(
        self, qs, k: int = 10, nprobe: int = 32, rescore_factor: int = 4,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[M, B, D] device-resident query batches -> (ids, scores) each
        [M, B, k], one batch after another (the reference's lax.scan)."""
        outs = [self.search_device(q, k, nprobe, rescore_factor) for q in qs]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    def calibrate_nprobe(
        self,
        target_recall: float = 0.95,
        k: int = 10,
        sample: int = 256,
        ladder: Tuple[int, ...] = (4, 8, 16, 32, 64, 128, 256),
        seed: int = 1,
    ) -> Tuple[int, float]:
        """Smallest nprobe meeting `target_recall` on this corpus: a ladder
        of nprobe values on `sample` self-queries (corpus rows plus
        cluster-residual-scaled noise) against the engine's own
        exhaustive-probe search; the first rung that meets the target and
        its recall (see `calibrate_nprobe_ladder`)."""
        idx = np.random.default_rng(seed).integers(0, self.n, sample)
        base = self._corpus_dev[torch.from_numpy(idx).to(self.device)]
        return calibrate_nprobe_ladder(
            self, base.cpu().numpy(), idx, target_recall=target_recall, k=k,
            ladder=ladder, seed=seed)


def calibrate_nprobe_ladder(
    engine,                  # any IVF engine: .search/.n_clusters/...
    base: np.ndarray,        # [sample, D] f32 corpus rows to query near
    idx: np.ndarray,         # [sample] their corpus row ids
    target_recall: float = 0.95,
    k: int = 10,
    ladder: Tuple[int, ...] = (4, 8, 16, 32, 64, 128, 256),
    seed: int = 1,
    frame_base: Optional[np.ndarray] = None,  # base in the centers' frame
) -> Tuple[int, float]:
    """Shared ladder walk of the IVF engines (`IvfEngine.calibrate_nprobe`
    documents it)."""
    rng = np.random.default_rng(seed)
    fb = base if frame_base is None else frame_base
    resid = fb - engine.centers[engine.assign[idx]]
    rstd = float(resid.std()) or 1e-3
    q = base + rstd * rng.standard_normal(base.shape).astype(np.float32)
    if engine.metric_in == "cosine":
        q = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-12)

    oracle, _ = engine.search(q, k=k, nprobe=engine.n_clusters)
    osets = [set(row.tolist()) for row in oracle]
    best = (engine.n_clusters, 1.0)
    for nprobe in ladder:
        if nprobe >= engine.n_clusters:
            break
        ids, _ = engine.search(q, k=k, nprobe=nprobe)
        rec = float(np.mean([
            len(set(row.tolist()) & osets[i]) / k
            for i, row in enumerate(ids)
        ]))
        if rec >= target_recall:
            return nprobe, rec
    return best


def ivf_search(
    queries, centroids, bucket_ids, bucket_vecs, bucket_sq,
    k: int, nprobe: int, metric: str, sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage-1 candidate generation: bf16 bucket scan (exact float32
    products of bf16 values, float32 sums) with a running top-k over the
    probes; callers rescore the survivors in f32 (IvfEngine.search).
    Returns (scores [B, k], ids [B, k] int64, -1 for empty slots)."""
    b = queries.shape[0]
    dev = queries.device
    c_scores = pairwise_scores(queries, centroids, metric)
    _, probe = topk_stable(c_scores, nprobe)                 # [B, P]
    q_score = queries.to(torch.bfloat16).float()
    best_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    best_ids = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for p in range(nprobe):
        cluster = probe[:, p]                                # [B]
        vecs = bucket_vecs[cluster].float()                  # [B, cap, D]
        ids = bucket_ids[cluster].long()                     # [B, cap]
        dots = torch.einsum("bcd,bd->bc", vecs, q_score)
        scores = 2.0 * dots - bucket_sq[cluster] if metric == "l2" else dots
        scores = torch.where(ids == sentinel, NEG_INF, scores)
        safe_ids = torch.where(ids == sentinel, -1, ids)
        all_scores = torch.cat([best_scores, scores], dim=1)
        all_ids = torch.cat([best_ids, safe_ids], dim=1)
        best_scores, pos = topk_stable(all_scores, k)
        best_ids = torch.gather(all_ids, 1, pos)
    return best_scores, best_ids
