"""IVF-PQ: ADC-compressed bucket scans for corpora too large for the bf16
IVF tables (port of `leann_tpu/ops/ivf_pq.py`).

The bf16 IVF engine (`ops/ivf.py`) keeps 2 bytes per dimension of bucket
payload plus a float32 rescore corpus resident. This engine stores each
row as its PQ-encoded RESIDUAL against the bucket centroid (m uint8
codes + one f32 norm), scans probed buckets by ADC table lookup, and
rescores the survivors exactly against an int8 (or bf16 / f32) corpus:
at 100M x 96 with m=16 that is 1.6 GB of codes, 0.4 GB of norms, 0.4 GB
of ids and 9.6 GB of int8 rescore rows.

Score algebra (l2, the negated-distance convention of the other
engines): with x_hat = c + r_hat,

    -|q - x_hat|^2 + |q|^2 = 2<q,c> + 2<q,r_hat> - |x_hat|^2

- 2<q,c> is one scalar per probed bucket.
- 2<q,r_hat> = sum_j LUT[b, j, code_j]; the LUT [B, m, ksub] is one
  product per query batch against the global residual codebooks.
- |x_hat|^2 is stored in f32 per row at build time.

For ip the centroid and LUT terms lose their factor 2 and the norm
column drops out. An optional OPQ rotation rotates the space before
k-means + residual PQ; queries are rotated by one [B, D] x [D, D]
product and the exact rescore stays in the original frame.

The scan is plain PyTorch, as the reference's is XLA outside any Pallas
kernel: bucket gather -> LUT lookup -> running top-C over the probes.
The reference sums a one-hot times a bf16-rounded LUT because scalar
gathers are slow on its device; here the LUT entries are gathered by
code. What carries over is the arithmetic: the LUT rounded to bf16, the m
terms added in float32 in the order j = 0..m-1 from zero. Every top-k is
`topk_stable` (the `jax.lax.top_k` tie order).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from leann_tpu_torch.device import DeviceLike, resolve_device
from leann_tpu_torch.ops.distance import NEG_INF, pairwise_scores, topk_stable
from leann_tpu_torch.ops.ivf import (
    bucket_rows, calibrate_nprobe_ladder, device_queries, kmeans,
    search_sizes,
)
from leann_tpu_torch.ops.pq import encode_pq, train_pq

# rows per device chunk of the build-time passes over the corpus
_BUILD_CHUNK = 1 << 20


def pack_pq_buckets(
    assign: np.ndarray,     # [N] int32 cluster ids
    codes: np.ndarray,      # [N, m] uint8 residual PQ codes
    nsq: np.ndarray,        # [N] f32 |x_hat|^2
    centers: np.ndarray,    # [K, D] f32
    n: int,
    cap: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (bucket_ids [K', cap], bucket_cent [K', D],
    bucket_codes [K', cap, m], bucket_nsq [K', cap]). Overflow rows
    become extra buckets sharing the parent centroid (same policy as
    ops/ivf.pack_buckets); empty slots carry the id sentinel `n`."""
    m = codes.shape[1]
    cap, rows = bucket_rows(assign, centers.shape[0], n, cap)
    kp = len(rows)
    bucket_ids = np.full((kp, cap), n, dtype=np.int32)
    bucket_cent = np.zeros((kp, centers.shape[1]), dtype=np.float32)
    bucket_codes = np.zeros((kp, cap, m), dtype=np.uint8)
    bucket_nsq = np.zeros((kp, cap), dtype=np.float32)
    for row, (c, ids) in enumerate(rows):
        bucket_ids[row, :len(ids)] = ids
        bucket_cent[row] = centers[c]
        if len(ids):
            bucket_codes[row, :len(ids)] = codes[ids]
            bucket_nsq[row, :len(ids)] = nsq[ids]
    return bucket_ids, bucket_cent, bucket_codes, bucket_nsq


def _reconstruction_sq_norms(centers, assign, codes, books, dev) -> np.ndarray:
    """[N] f32 |c + r_hat|^2 in the decomposed form |c|^2 + 2<c, r_hat> +
    |r_hat|^2 with r_hat = sum_j book_j (no full reconstruction): the
    per-(cell, subspace, code) tables once, then per-row sums by code
    lookup, on the device in row chunks."""
    k, d = centers.shape
    m, ksub, dsub = books.shape
    cen = torch.from_numpy(np.ascontiguousarray(centers, np.float32)).to(dev)
    bk = torch.from_numpy(np.ascontiguousarray(books, np.float32)).to(dev)
    cb = torch.einsum("cjd,jkd->cjk", cen.reshape(k, m, dsub), bk).reshape(-1)
    bb = (bk * bk).sum(2).reshape(-1)                        # [m * ksub]
    csq = (cen * cen).sum(1)                                 # [K]
    col = torch.arange(m, device=dev) * ksub                 # [m]
    n = assign.shape[0]
    out = np.empty(n, np.float32)
    for s in range(0, n, _BUILD_CHUNK):
        a = torch.from_numpy(assign[s : s + _BUILD_CHUNK]).to(dev).long()
        c = torch.from_numpy(codes[s : s + _BUILD_CHUNK]).to(dev).long()
        pos = col[None, :] + c                               # [C, m]
        out[s : s + _BUILD_CHUNK] = (
            csq[a]
            + 2.0 * cb[a[:, None] * (m * ksub) + pos].sum(1)
            + bb[pos].sum(1)
        ).cpu().numpy()
    return out


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, bfloat16 (ml_dtypes) arrays by their bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class IvfPqEngine:
    """IVF with ADC-compressed buckets + exact int8/bf16/f32 rescore, on
    `device` (default cuda).

    API mirrors ops/ivf.IvfEngine (search / search_device /
    search_many_device); `rescore_factor*k` ADC survivors per query are
    exactly rescored. `rescore="int8"` (default) keeps the full corpus
    at 1 byte/dim as residuals against the assigned centroid with a
    per-row scale; bf16/f32 where they fit. `build_seconds` holds the
    constructor's wall seconds by step."""

    def __init__(
        self,
        vectors: np.ndarray,
        n_clusters: Optional[int] = None,
        metric: str = "ip",
        m: int = 16,
        ksub: int = 256,
        kmeans_iters: int = 8,
        pq_iters: int = 10,
        cap: Optional[int] = None,
        rescore: str = "int8",
        train_sample: int = 262_144,
        seed: int = 0,
        rotation: Optional[np.ndarray] = None,  # [D, D] OPQ
        centers: Optional[np.ndarray] = None,   # rotated-frame if rot
        assign: Optional[np.ndarray] = None,
        device: DeviceLike = None,
    ):
        self.device = dev = resolve_device(device)
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.metric_in = metric
        if metric == "cosine":
            vectors = vectors / (
                np.linalg.norm(vectors, axis=1, keepdims=True) + 1e-12
            )
            metric = "ip"
        self.metric = metric
        self.n, self.d = vectors.shape
        if self.d % m:
            raise ValueError(f"d={self.d} not divisible by m={m}")
        if rescore not in ("int8", "bf16", "f32"):
            raise ValueError(f"rescore must be int8, bf16 or f32 "
                             f"(got {rescore!r})")
        self.m, self.ksub = m, ksub
        if centers is not None:
            n_clusters = centers.shape[0]
        elif n_clusters is None:
            n_clusters = max(16, int(np.sqrt(self.n) * 2))
        self.n_clusters = min(n_clusters, self.n)

        self.rotation = None
        enc = vectors
        if rotation is not None:
            self.rotation = np.ascontiguousarray(rotation, np.float32)
            if self.rotation.shape != (self.d, self.d):
                raise ValueError("rotation must be [D, D]")
            enc = vectors @ self.rotation

        secs: Dict[str, float] = {}
        t0 = time.perf_counter()
        if centers is None or assign is None:
            centers, assign = kmeans(
                enc, self.n_clusters, iters=kmeans_iters,
                metric=self.metric, seed=seed, device=dev,
            )
        centers = np.ascontiguousarray(centers, np.float32)
        assign = np.ascontiguousarray(assign, np.int32)
        self.centers = centers
        self.assign = assign
        secs["kmeans"] = time.perf_counter() - t0

        # residuals in the (rotated) coarse frame; global books trained
        # on a sample, all rows encoded
        t0 = time.perf_counter()
        resid = enc - centers[assign]
        rng = np.random.default_rng(seed)
        samp = resid[rng.choice(
            self.n, min(train_sample, self.n), replace=False)]
        self.books = train_pq(samp, m=m, ksub=ksub, iters=pq_iters,
                              seed=seed, device=dev)
        secs["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        codes = encode_pq(resid, self.books, device=dev)
        del resid
        secs["encode"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        if metric == "l2":
            nsq = _reconstruction_sq_norms(centers, assign, codes,
                                           self.books, dev)
        else:
            nsq = np.zeros(self.n, np.float32)
        secs["norms"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        tables = pack_pq_buckets(assign, codes, nsq, centers, self.n, cap=cap)
        (self.bucket_ids, self.bucket_cent, self.bucket_codes,
         self.bucket_nsq) = (torch.from_numpy(t).to(dev) for t in tables)
        self.cap = self.bucket_ids.shape[1]
        self.books_dev = torch.from_numpy(self.books).to(dev)
        secs["pack"] = time.perf_counter() - t0

        # exact-rescore corpus in the ORIGINAL frame (scores are
        # rotation-invariant). int8 stores RESIDUALS against the assigned
        # coarse centroid, so the 8 bits span the cluster radius instead
        # of the corpus radius; the centroid comes back at score time.
        t0 = time.perf_counter()
        self.rescore = rescore
        self.corpus_scale = None
        self.corpus_cent = None
        self.corpus_assign = None
        store = {"int8": torch.int8, "bf16": torch.bfloat16,
                 "f32": torch.float32}[rescore]
        self.corpus = torch.empty((self.n, self.d), dtype=store, device=dev)
        self.corpus_nsq = torch.empty((self.n,), dtype=torch.float32,
                                      device=dev)
        if rescore == "int8":
            cent_orig = (centers if self.rotation is None
                         else centers @ self.rotation.T)
            self.corpus_cent = torch.from_numpy(
                np.ascontiguousarray(cent_orig, np.float32)).to(dev)
            self.corpus_assign = torch.from_numpy(assign).to(dev)
            self.corpus_scale = torch.empty((self.n,), dtype=torch.float32,
                                            device=dev)
        for s in range(0, self.n, _BUILD_CHUNK):
            e = min(self.n, s + _BUILD_CHUNK)
            v = torch.from_numpy(vectors[s:e]).to(dev)
            # |x|^2 summed in float64, as the reference's host einsum
            self.corpus_nsq[s:e] = (v.double() ** 2).sum(1).float()
            if rescore == "int8":
                r = v - self.corpus_cent[self.corpus_assign[s:e].long()]
                scale = r.abs().amax(1).clamp_min(1e-12)
                self.corpus[s:e] = torch.clamp(
                    torch.round(r / scale[:, None] * 127.0), -127, 127
                ).to(torch.int8)
                self.corpus_scale[s:e] = scale / 127.0
            else:
                self.corpus[s:e] = v.to(store)
        self.rot_dev = (torch.from_numpy(self.rotation).to(dev)
                        if self.rotation is not None else None)
        secs["rescore_corpus"] = time.perf_counter() - t0
        self.build_seconds = secs

    # ------------------------------------------------------------ search

    def search(self, queries, k: int = 10, nprobe: int = 32,
               rescore_factor: int = 16) -> Tuple[np.ndarray, np.ndarray]:
        """Returns numpy (ids [B, k], -1 where fewer than k, scores)."""
        ids, scores = self.search_device(
            queries, k=k, nprobe=nprobe, rescore_factor=rescore_factor)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def search_device(self, queries, k: int = 10, nprobe: int = 32,
                      rescore_factor: int = 16):
        """Device-out search: (ids, scores) on the device."""
        return self._search(device_queries(queries, self.device,
                                           self.metric_in),
                            k, nprobe, rescore_factor)

    def _search(self, q, k, nprobe, rescore_factor):
        k, nprobe, c = search_sizes(self, k, nprobe, rescore_factor)
        return ivfpq_search(
            q, self.bucket_cent, self.bucket_ids, self.bucket_codes,
            self.bucket_nsq, self.books_dev, self.corpus, self.corpus_nsq,
            self.corpus_scale, self.corpus_cent, self.corpus_assign,
            self.rot_dev, k=k, c=c, nprobe=nprobe, metric=self.metric,
            sentinel=self.n)

    def search_many_device(self, qs, k: int = 10, nprobe: int = 32,
                           rescore_factor: int = 16):
        """[M, B, D] device-resident batches -> (ids, scores) [M, B, k],
        one batch after another (the reference's lax.scan). The queries go
        in as they are, as in the reference: a cosine engine's scores then
        carry |q|."""
        outs = [self._search(q.to(torch.float32), k, nprobe, rescore_factor)
                for q in qs]
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
        """Smallest nprobe meeting `target_recall`: the ladder walk of
        IvfEngine.calibrate_nprobe through this engine's ADC search. Base
        rows come from the rescore corpus (dequantized when int8)."""
        idx = np.random.default_rng(seed).integers(0, self.n, sample)
        pos = torch.from_numpy(idx).to(self.device)
        base = self.corpus[pos].float()
        if self.corpus_scale is not None:
            base = base * self.corpus_scale[pos][:, None]
        if self.corpus_cent is not None:
            base = base + self.corpus_cent[
                torch.from_numpy(self.assign[idx]).to(self.device).long()]
        base = base.cpu().numpy()
        # centers/assign live in the rotated frame (OPQ); only the
        # residual-spread scalar is frame-sensitive
        fb = base @ self.rotation if self.rotation is not None else None
        return calibrate_nprobe_ladder(
            self, base, idx, target_recall=target_recall, k=k,
            ladder=ladder, seed=seed, frame_base=fb)


def state_from_reference(arrays: Dict[str, object],
                         device: DeviceLike = None) -> IvfPqEngine:
    """An engine that searches the reference engine's own tables, given
    as numpy arrays: `bucket_ids`, `bucket_cent`, `bucket_codes`,
    `bucket_nsq`, `books`, `corpus` (int8, bfloat16 or float32),
    `corpus_nsq`, `corpus_scale`, `corpus_cent`, `corpus_assign`,
    `rotation` (each of the last four may be None), `metric` (the
    constructor's, so "cosine" normalizes queries), `n`, and `centers` /
    `assign` where `calibrate_nprobe` is wanted. Nothing is trained or
    packed."""
    dev = resolve_device(device)
    eng = IvfPqEngine.__new__(IvfPqEngine)
    eng.device = dev
    eng.metric_in = arrays["metric"]
    eng.metric = "ip" if eng.metric_in == "cosine" else eng.metric_in
    eng.n = int(arrays["n"])

    def put(name):
        a = arrays.get(name)
        return None if a is None else _to_torch(np.asarray(a)).to(dev)

    for name in ("bucket_ids", "bucket_cent", "bucket_codes", "bucket_nsq",
                 "corpus", "corpus_nsq", "corpus_scale", "corpus_cent",
                 "corpus_assign"):
        setattr(eng, name, put(name))
    eng.books = np.ascontiguousarray(arrays["books"], np.float32)
    eng.books_dev = torch.from_numpy(eng.books).to(dev)
    eng.m, eng.ksub = eng.books.shape[:2]
    eng.d = eng.corpus.shape[1]
    eng.cap = eng.bucket_ids.shape[1]
    rot = arrays.get("rotation")
    eng.rotation = (None if rot is None
                    else np.ascontiguousarray(rot, np.float32))
    eng.rot_dev = put("rotation")
    eng.rescore = {torch.int8: "int8", torch.bfloat16: "bf16",
                   torch.float32: "f32"}[eng.corpus.dtype]
    eng.centers = arrays.get("centers")
    eng.assign = arrays.get("assign")
    eng.n_clusters = (eng.centers.shape[0] if eng.centers is not None
                      else eng.bucket_cent.shape[0])
    eng.build_seconds = {}
    return eng


def ivfpq_search(
    queries, bucket_cent, bucket_ids, bucket_codes, bucket_nsq, books,
    corpus, corpus_nsq, corpus_scale, corpus_cent, corpus_assign, rot,
    k: int, c: int, nprobe: int, metric: str, sentinel: int,
):
    """ADC bucket scan (a running top-C over the probes) + exact rescore
    of the C survivors in float32 (TF32 off on the card). Returns
    (ids [B, k] int64, -1 where empty, scores [B, k])."""
    b, _ = queries.shape
    m, ksub, dsub = books.shape
    dev = queries.device
    cap = bucket_ids.shape[1]

    qr = queries if rot is None else queries @ rot
    # per-query ADC tables: [B, m, ksub] in one product
    luts = torch.einsum("bjd,jkd->bjk", qr.reshape(b, m, dsub), books)
    if metric == "l2":
        luts = 2.0 * luts
    # the reference contracts a one-hot with the bf16-rounded LUT: each
    # term is that bf16 entry, exact in float32
    luts_bf = luts.to(torch.bfloat16).float()

    c_scores = pairwise_scores(qr, bucket_cent, metric)
    _, probe = topk_stable(c_scores, nprobe)                 # [B, P]

    cc = min(c, cap * nprobe)
    best_scores = torch.full((b, cc), NEG_INF, dtype=torch.float32, device=dev)
    best_ids = torch.full((b, cc), -1, dtype=torch.int64, device=dev)
    for p in range(nprobe):
        cluster = probe[:, p]                                # [B]
        ids = bucket_ids[cluster].long()                     # [B, cap]
        codes = bucket_codes[cluster]                        # [B, cap, m]
        # float32 sum of the m LUT entries, j = 0..m-1 from zero (the
        # order decides the last bit, and with it who survives the top-C)
        adc = torch.zeros((b, cap), dtype=torch.float32, device=dev)
        for j in range(m):
            adc = adc + torch.gather(luts_bf[:, j], 1, codes[:, :, j].long())
        cdot = (bucket_cent[cluster] * qr).sum(1)
        if metric == "l2":
            scores = 2.0 * cdot[:, None] + adc - bucket_nsq[cluster]
        else:
            scores = cdot[:, None] + adc
        scores = torch.where(ids == sentinel, NEG_INF, scores)
        safe_ids = torch.where(ids == sentinel, -1, ids)
        all_scores = torch.cat([best_scores, scores], dim=1)
        all_ids = torch.cat([best_ids, safe_ids], dim=1)
        best_scores, pos = topk_stable(all_scores, cc)
        best_ids = torch.gather(all_ids, 1, pos)

    # exact rescore in the ORIGINAL frame (rotation-invariant scores)
    cand = best_ids
    gid = cand.clamp_min(0)                                  # int64
    rows = corpus[gid].float()                               # [B, C, D]
    if corpus_scale is not None:
        rows = rows * corpus_scale[gid][:, :, None]
    if corpus_cent is not None:
        # int8 residual payload: add the assigned centroid back
        rows = rows + corpus_cent[corpus_assign[gid].long()]
    dots = torch.einsum("bcd,bd->bc", rows, queries)
    scores = 2.0 * dots - corpus_nsq[gid] if metric == "l2" else dots
    scores = torch.where(cand < 0, NEG_INF, scores)
    # ids are unique across buckets by construction: no dedup needed
    top_scores, pos = topk_stable(scores, k)
    top_ids = torch.gather(cand, 1, pos)
    return torch.where(top_scores == NEG_INF, -1, top_ids), top_scores
