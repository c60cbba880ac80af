"""IVF with a residual-int8 bucket payload (port of
`leann_tpu/ops/ivf_int8.py`), the reference's serving tier for 10M-class
corpora on one device.

Each row is stored once, as int8 of its residual against its bucket's
centroid with a per-row scale (x ~= c + s * r8), packed by bucket, with
its exact f32 |x|^2. Search scores the probed buckets as
`<q, c> + s * <bf16(q), r8>` (l2: `2 * that - |x|^2`), keeps the top C
by packed position, and rescores those C exactly from the same payload
(f32 dequant + centroid add-back), so no second corpus copy exists.

Two scans, as in the reference: `ivf8_search`, a running top-C over the
probes in plain PyTorch (gather + products, which the reference left to
XLA), and with LEANN_IVF8_PALLAS=1 `_ivf8_search_pallas_impl`, which
scores every probed bucket with kernel B2 (`ops/bucket_kernels.py`,
CUDA on the card) and takes one top-C over [B, P*cap].
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from leann_tpu_torch.device import DeviceLike, resolve_device
from leann_tpu_torch.ops.distance import NEG_INF, pairwise_scores, topk_stable
from leann_tpu_torch.ops.ivf import (
    bucket_rows, calibrate_nprobe_ladder, device_queries, kmeans,
    search_sizes,
)


def pack_int8_buckets(
    vectors: np.ndarray,    # [N, D] f32
    assign: np.ndarray,     # [N] int32
    centers: np.ndarray,    # [K, D] f32
    cap: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (bucket_ids [K', cap], bucket_cent [K', D],
    payload [K', cap, D] int8, scale [K', cap] f32, nsq [K', cap] f32).
    Overflow rows become extra buckets sharing the parent centroid
    (same policy as ops/ivf.pack_buckets); empty slots: id sentinel n,
    zero payload/scale/nsq."""
    n, d = vectors.shape
    cap, rows = bucket_rows(assign, centers.shape[0], n, cap)
    kp = len(rows)
    bucket_ids = np.full((kp, cap), n, dtype=np.int32)
    bucket_cent = np.zeros((kp, d), dtype=np.float32)
    payload = np.zeros((kp, cap, d), dtype=np.int8)
    scale = np.zeros((kp, cap), dtype=np.float32)
    nsq = np.zeros((kp, cap), dtype=np.float32)
    for row, (c, ids) in enumerate(rows):
        bucket_ids[row, :len(ids)] = ids
        bucket_cent[row] = centers[c]
        if len(ids):
            v = vectors[ids]
            r = v - centers[c][None, :]
            s = np.maximum(np.abs(r).max(axis=1), 1e-12).astype(np.float32)
            payload[row, :len(ids)] = np.clip(
                np.round(r / s[:, None] * 127.0), -127, 127
            ).astype(np.int8)
            scale[row, :len(ids)] = s / 127.0
            nsq[row, :len(ids)] = np.einsum(
                "nd,nd->n", v, v, dtype=np.float64
            ).astype(np.float32)
    return bucket_ids, bucket_cent, payload, scale, nsq


class IvfInt8Engine:
    """API mirrors IvfEngine (search / search_device / search_many_device
    / calibrate_nprobe), on `device` (default cuda)."""

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
        if centers is not None:
            n_clusters = centers.shape[0]
        elif n_clusters is None:
            n_clusters = max(16, int(np.sqrt(self.n) * 2))
        self.n_clusters = min(n_clusters, self.n)
        if centers is None or assign is None:
            centers, assign = kmeans(
                vectors, self.n_clusters, iters=kmeans_iters,
                metric=self.metric, seed=seed, device=self.device,
            )
        self.centers = centers
        self.assign = assign
        tables = pack_int8_buckets(vectors, assign, centers, cap=cap)
        self.cap = tables[0].shape[1]
        (self.bucket_ids, self.bucket_cent, self.payload, self.scale,
         self.nsq) = (torch.from_numpy(t).to(self.device) for t in tables)
        self._ptab = None

    # ------------------------------------------------------------ search

    def search(self, queries, k: int = 10, nprobe: int = 32,
               rescore_factor: int = 4) -> Tuple[np.ndarray, np.ndarray]:
        """Returns numpy (ids [B, k], -1 where fewer than k, scores)."""
        ids, scores = self.search_device(
            queries, k=k, nprobe=nprobe, rescore_factor=rescore_factor)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def _use_pallas(self) -> bool:
        """LEANN_IVF8_PALLAS=1 routes the scan through kernel B2, as it
        routes the reference's through its Pallas kernel."""
        return os.environ.get("LEANN_IVF8_PALLAS") == "1"

    def _pallas_tables(self):
        """Tables of kernel B2 (built once): empty slots carry id -1.
        The reference also pads cap to 32 and D to 128 for its TPU tiling;
        the CUDA kernel takes the unpadded tables, so only the ids are
        new. Returns (payload, scale, nsq, ids, cent, cap, D)."""
        if self._ptab is None:
            ids = torch.where(self.bucket_ids == self.n, -1, self.bucket_ids)
            self._ptab = (self.payload, self.scale, self.nsq, ids,
                          self.bucket_cent, self.cap, self.d)
        return self._ptab

    def search_device(self, queries, k: int = 10, nprobe: int = 32,
                      rescore_factor: int = 4):
        """Device-out search: (ids, scores) on the device."""
        return self._search(device_queries(queries, self.device,
                                           self.metric_in),
                            k, nprobe, rescore_factor)

    def _search(self, q, k, nprobe, rescore_factor):
        k, nprobe, c = search_sizes(self, k, nprobe, rescore_factor)
        if self._use_pallas():
            pay, sc, ns, ids, cent, cap_pad, d_pad = self._pallas_tables()
            return _ivf8_search_pallas_impl(
                q, self.bucket_cent, pay, sc, ns, ids, cent, k=k, c=c,
                nprobe=nprobe, metric=self.metric, cap_pad=cap_pad,
                d_pad=d_pad)
        return ivf8_search(
            q, self.bucket_cent, self.bucket_ids, self.payload, self.scale,
            self.nsq, k=k, c=c, nprobe=nprobe, metric=self.metric,
            sentinel=self.n)

    def search_many_device(self, qs, k: int = 10, nprobe: int = 32,
                           rescore_factor: int = 4):
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
        """Same ladder walk as IvfEngine.calibrate_nprobe. Base rows are
        dequantized from the packed payload (gathered on the device)."""
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, self.n, sample)
        # packed position of each sampled global id
        ids_flat = self.bucket_ids.reshape(-1).cpu().numpy()
        pos_of = np.full(self.n + 1, -1, np.int64)
        pos_of[ids_flat] = np.arange(ids_flat.shape[0])
        pos = torch.from_numpy(pos_of[idx]).to(self.device)
        pay = self.payload.reshape(-1, self.d)[pos].float()
        sc = self.scale.reshape(-1)[pos]
        cent = self.bucket_cent[pos // self.cap]
        base = (cent + pay * sc[:, None]).cpu().numpy()
        return calibrate_nprobe_ladder(
            self, base, idx, target_recall=target_recall, k=k,
            ladder=ladder, seed=seed)


def _rescore_packed(queries, payload, scale, nsq, cent, cand_pos, cap,
                    metric):
    """Exact f32 rescore of packed positions [B, C] (int64, >= 0) from the
    payload: rows dequantized and the centroid added back; float32
    products and sums (TF32 off on the card)."""
    d = payload.shape[2]
    rows = payload.reshape(-1, d)[cand_pos].float()          # [B, C, D]
    rows = rows * scale.reshape(-1)[cand_pos][:, :, None]
    rows = rows + cent[cand_pos // cap]
    dots = torch.einsum("bcd,bd->bc", rows, queries)
    return 2.0 * dots - nsq.reshape(-1)[cand_pos] if metric == "l2" else dots


def _ivf8_search_pallas_impl(
    queries, bucket_cent, payload, scale, nsq, ids, cent_pad,
    k: int, c: int, nprobe: int, metric: str, cap_pad: int, d_pad: int,
):
    """Kernel-scan variant: every probed bucket is scored by kernel B2
    (`ivf8_bucket_scores`); candidate positions come from the probe
    table, so only the top-C rescore gathers rows. Any B: there is no
    probe table in scalar memory to chunk for. The tables may carry the
    reference's padding (cap_pad, d_pad); positions are int64. Returns
    (ids [B, k] int64, -1 where empty, scores [B, k])."""
    from leann_tpu_torch.ops.bucket_kernels import ivf8_bucket_scores

    b, d = queries.shape
    q_pad = queries
    if d != d_pad:
        q_pad = torch.nn.functional.pad(queries, (0, d_pad - d))
    c_scores = pairwise_scores(queries, bucket_cent, metric)
    _, probe = topk_stable(c_scores, nprobe)                 # [B, P]
    scores = ivf8_bucket_scores(
        q_pad, probe.to(torch.int32), payload, scale, nsq, ids, cent_pad,
        metric)                                              # [B, P, cap]
    pos = probe[:, :, None] * cap_pad + torch.arange(
        cap_pad, device=queries.device)                      # int64
    cc = min(c, cap_pad * nprobe)
    cand_scores, sel = topk_stable(scores.reshape(b, nprobe * cap_pad), cc)
    cand_pos = torch.gather(pos.reshape(b, nprobe * cap_pad), 1, sel)

    gids = ids.reshape(-1)[cand_pos].long()                  # [B, C]
    out = _rescore_packed(q_pad, payload, scale, nsq, cent_pad, cand_pos,
                          cap_pad, metric)
    out = torch.where((gids < 0) | (cand_scores == NEG_INF), NEG_INF, out)
    top_scores, sel = topk_stable(out, k)
    top_ids = torch.gather(gids, 1, sel)
    return torch.where(top_scores == NEG_INF, -1, top_ids), top_scores


def ivf8_search(
    queries, bucket_cent, bucket_ids, payload, scale, nsq,
    k: int, c: int, nprobe: int, metric: str, sentinel: int,
):
    """int8 bucket scan (a running top-C over the probes, candidates
    tracked by packed position) + f32-dequant rescore from the same
    payload. Returns (ids [B, k] int64, -1 where empty, scores [B, k])."""
    b, _ = queries.shape
    cap = bucket_ids.shape[1]
    dev = queries.device
    c_scores = pairwise_scores(queries, bucket_cent, metric)
    _, probe = topk_stable(c_scores, nprobe)                 # [B, P]

    q_bf = queries.to(torch.bfloat16).float()
    cc = min(c, cap * nprobe)
    best_scores = torch.full((b, cc), NEG_INF, dtype=torch.float32, device=dev)
    best_pos = torch.full((b, cc), -1, dtype=torch.int64, device=dev)
    slot = torch.arange(cap, device=dev)
    for p in range(nprobe):
        cluster = probe[:, p]                                # [B]
        ids = bucket_ids[cluster]                            # [B, cap]
        # int8 -> float is exact, as int8 -> bf16 is in the reference
        rdots = torch.einsum("bcd,bd->bc", payload[cluster].float(), q_bf)
        # residual payload: x = c + s*r8, so <q,x> = <q,c> + s<q,r8>
        cdot = (bucket_cent[cluster] * queries).sum(1)
        dots = cdot[:, None] + rdots * scale[cluster]
        scores = 2.0 * dots - nsq[cluster] if metric == "l2" else dots
        scores = torch.where(ids == sentinel, NEG_INF, scores)
        pos = cluster[:, None] * cap + slot
        all_scores = torch.cat([best_scores, scores], dim=1)
        all_pos = torch.cat([best_pos, pos], dim=1)
        best_scores, sel = topk_stable(all_scores, cc)
        best_pos = torch.gather(all_pos, 1, sel)

    # exact rescore from the packed payload; invalid positions stay -inf
    gpos = best_pos.clamp_min(0)
    gids = bucket_ids.reshape(-1)[gpos].long()               # [B, C]
    scores = _rescore_packed(queries, payload, scale, nsq, bucket_cent, gpos,
                             cap, metric)
    scores = torch.where((best_pos < 0) | (gids == sentinel), NEG_INF, scores)
    top_scores, sel = topk_stable(scores, k)
    top_ids = torch.gather(gids, 1, sel)
    return torch.where(top_scores == NEG_INF, -1, top_ids), top_scores
