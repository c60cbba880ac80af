"""Batched distance computation + exact top-k (port of
`leann_tpu/ops/distance.py`).

Score convention throughout the engine: **higher is better**.
  ip:      score = q . v
  cosine:  score = (q . v) / (|q||v|)
  l2:      score = -(|v|^2 - 2 q . v)   (the constant |q|^2 is dropped)

Full-precision paths are plain float32 matmuls; on CUDA they need TF32
off (`torch.backends.cuda.matmul.allow_tf32 = False`, PyTorch's default).
Top-k merges use a stable descending sort so that equal scores keep the
lower index first, as `jax.lax.top_k` does.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from leann_tpu_torch.device import DeviceLike, resolve_device
from leann_tpu_torch.utils.trace import device_span

Metric = str  # "ip" | "l2" | "cosine"

NEG_INF = float("-inf")


def _normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + 1e-12)


def topk_stable(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, positions) of the k largest per row, ties to the lower
    position (the `jax.lax.top_k` order)."""
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def pairwise_scores(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    metric: Metric = "ip",
    vector_sq_norms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, D] x [C, D] -> [B, C] float32 scores (higher = better)."""
    if metric == "cosine":
        queries = _normalize(queries)
        vectors = _normalize(vectors)
        metric = "ip"
    dots = queries.float() @ vectors.float().T
    if metric == "ip":
        return dots
    if metric == "l2":
        if vector_sq_norms is None:
            vf = vectors.float()
            vector_sq_norms = (vf * vf).sum(-1)
        return 2.0 * dots - vector_sq_norms[None, :]
    raise ValueError(f"unknown metric {metric!r}")


def _exact_topk_scan(
    queries: torch.Tensor,   # [B, D] f32
    vectors: torch.Tensor,   # [N_pad, D] f32
    valid_n: int,
    k: int,
    metric: Metric,
    chunk_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corpus-chunked full-f32 scan with a running top-k merge: peak
    memory O(B * (k + chunk))."""
    b = queries.shape[0]
    if metric == "cosine":
        queries = _normalize(queries)
        vectors = _normalize(vectors)
        metric = "ip"
    dev = queries.device
    best_sc = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    best_ix = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for base in range(0, vectors.shape[0], chunk_size):
        block = vectors[base : base + chunk_size]
        sc = pairwise_scores(queries, block, metric)
        col = torch.arange(base, base + block.shape[0], device=dev)
        sc = torch.where(col[None, :] < valid_n, sc, NEG_INF)
        all_sc = torch.cat([best_sc, sc], dim=1)
        all_ix = torch.cat([best_ix, col[None, :].expand(b, -1)], dim=1)
        best_sc, pos = topk_stable(all_sc, k)
        best_ix = torch.gather(all_ix, 1, pos)
    return best_sc, best_ix


def _rescore_topk(
    queries: torch.Tensor,     # [B, D] f32
    vectors: torch.Tensor,     # [N_pad, D] f32
    cand_idx: torch.Tensor,    # [B, C] int64 (may contain -1)
    k: int,
    metric: Metric,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 2: full-f32 rescoring of the stage-1 survivors."""
    if metric == "cosine":
        queries = _normalize(queries)
        vectors = _normalize(vectors)
        metric = "ip"
    safe = cand_idx.clamp_min(0)
    vecs = vectors[safe]                                    # [B, C, D]
    dots = torch.einsum("bcd,bd->bc", vecs, queries)
    if metric == "l2":
        scores = 2.0 * dots - (vecs * vecs).sum(-1)
    else:
        scores = dots
    scores = torch.where(cand_idx >= 0, scores, NEG_INF)
    top_scores, pos = topk_stable(scores, k)
    return top_scores, torch.gather(cand_idx, 1, pos)


def make_bias(n: int, n_pad: int, metric: Metric,
              vectors: torch.Tensor) -> torch.Tensor:
    """Additive stage-1 bias row [N_pad] f32: the l2 -|v|^2 term and the
    padding mask (-1e30 on pad rows) in one broadcast add."""
    if metric == "l2":
        vf = vectors.float()
        bias = -(vf * vf).sum(-1)
    else:
        bias = torch.zeros((n_pad,), dtype=torch.float32, device=vectors.device)
    if n_pad > n:
        row = torch.arange(n_pad, device=vectors.device)
        bias = torch.where(row < n, bias, torch.full_like(bias, -1e30))
    return bias


@functools.lru_cache(maxsize=None)
def _mm_has_out_dtype() -> bool:
    """Whether this PyTorch's `torch.mm` takes `out_dtype` (a float32
    result from bf16 operands on CUDA)."""
    z = torch.zeros((1, 1), dtype=torch.bfloat16, device="cuda")
    try:
        torch.mm(z, z, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return False
    return True


def stage1_path(device: torch.device) -> str:
    """How `_two_stage` forms its float32 stage-1 dots on `device`:
    "out_dtype" (a bf16 GEMM with a float32 output, CUDA) or "widened"
    (both bf16 operands widened to float32 first)."""
    if device.type == "cuda" and _mm_has_out_dtype():
        return "out_dtype"
    return "widened"


def stage1_operand(vectors_bf16: torch.Tensor) -> torch.Tensor:
    """The corpus side of the stage-1 product, [D, N_pad]: the bf16 rows
    themselves where `stage1_path` is "out_dtype", else widened to
    float32 once per search."""
    if stage1_path(vectors_bf16.device) == "out_dtype":
        return vectors_bf16.T
    return vectors_bf16.float().T


def stage1_dots(queries: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """float32 [b, N_pad] dots of the bf16-rounded queries with the bf16
    corpus (`vt` from `stage1_operand`): exact products of bf16 values,
    float32 sums, no bf16 rounding of the result."""
    qq = queries.to(torch.bfloat16)
    if vt.dtype == torch.bfloat16:
        return torch.mm(qq, vt, out_dtype=torch.float32)
    return qq.float() @ vt


def _two_stage(
    queries: torch.Tensor,       # [B, D] f32
    vectors_bf16: torch.Tensor,  # [N_pad, D] bf16
    vectors: torch.Tensor,       # [N_pad, D] f32
    bias: torch.Tensor,          # [N_pad] f32 (make_bias)
    k: int,
    c: int,
    metric: Metric,
    qc: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-chunked bf16 scan keeping the top c per query, then the
    exact f32 rescore of those c. Returns (scores, ids).

    Stage 1 multiplies bf16 operands into a float32 result, as the
    reference's `preferred_element_type=jnp.float32` does: a bf16
    `torch.matmul` would round each dot to bf16 before the top-c.

    Device spans: per query chunk `exact.stage1` (the product, scale and
    bias) and `exact.select` (the top-c), then `exact.rescore`."""
    scale = 2.0 if metric == "l2" else 1.0
    vt = stage1_operand(vectors_bf16)
    cands = []
    for s in range(0, queries.shape[0], qc):
        with device_span("exact.stage1"):
            dots = stage1_dots(queries[s : s + qc], vt)
            sc = scale * dots + bias[None, :]
        with device_span("exact.select"):
            cands.append(torch.topk(sc, c, dim=1).indices)
    with device_span("exact.rescore"):
        cand = torch.cat(cands, dim=0)
        return _rescore_topk(queries, vectors, cand, k, metric)


class ExactEngine:
    """Device-resident exact search engine (the flat path and the recall
    oracle of every other engine): the corpus lives on the device once,
    f32 for rescoring plus a bf16 copy for the stage-1 scan."""

    def __init__(self, vectors: np.ndarray, metric: Metric = "ip",
                 chunk_size: int = 65536, device: DeviceLike = None):
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
        self.chunk_size = min(
            chunk_size, max(128, 1 << (self.n - 1).bit_length())
        )
        n_pad = -(-self.n // self.chunk_size) * self.chunk_size
        if n_pad != self.n:
            vectors = np.concatenate(
                [vectors, np.zeros((n_pad - self.n, self.d), np.float32)]
            )
        self.vectors = torch.from_numpy(vectors).to(self.device)
        self.vectors_bf16 = self.vectors.to(torch.bfloat16)
        self.bias = make_bias(self.n, n_pad, metric, self.vectors)

    def _queries(self, queries) -> torch.Tensor:
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if self.metric_in == "cosine":
            q = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-12)
        return torch.from_numpy(np.ascontiguousarray(q)).to(self.device)

    def search(
        self, queries: np.ndarray, k: int = 10, rescore_factor: int = 8,
        exact_scan: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (idx [B, k], scores [B, k]); exact_scan=True runs the
        full-f32 scan instead of bf16 + rescore."""
        qd = self._queries(queries)
        k = min(k, self.n)
        if exact_scan:
            scores, idx = _exact_topk_scan(
                qd, self.vectors, self.n, k, self.metric, self.chunk_size)
        else:
            idx, scores = self.search_device(qd, k, rescore_factor)
        return idx.cpu().numpy(), scores.cpu().numpy()

    def search_device(
        self, queries: torch.Tensor, k: int = 10, rescore_factor: int = 8
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-in/device-out two-stage search. Returns (ids, scores),
        the order every engine's search_device shares."""
        k = min(k, self.n)
        c = min(max(rescore_factor * k, k), self.n)
        scores, idx = _two_stage(
            queries, self.vectors_bf16, self.vectors, self.bias,
            k, c, self.metric,
        )
        return idx, scores

    def search_many_device(
        self, qs: torch.Tensor, k: int = 10, rescore_factor: int = 8
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[M, B, D] device-resident query batches -> (ids [M, B, k],
        scores [M, B, k]), in the device span `exact.search_many`."""
        with device_span("exact.search_many"):
            outs = [self.search_device(q, k, rescore_factor) for q in qs]
            return (torch.stack([o[0] for o in outs]),
                    torch.stack([o[1] for o in outs]))


def exact_topk(
    queries,
    vectors,
    k: int,
    metric: Metric = "ip",
    chunk_size: int = 65536,
    two_stage: bool = False,
    rescore_factor: int = 8,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k over the full corpus. Returns (scores [B,k], idx [B,k]).

    two_stage=True scans in bf16 keeping rescore_factor*k candidates and
    rescores them in full f32."""
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(queries, dtype=np.float32), device=dev)
    if q.ndim == 1:
        q = q[None, :]
    v = torch.as_tensor(np.asarray(vectors, dtype=np.float32), device=dev)
    n, d = v.shape
    k = min(k, n)
    chunk_size = min(chunk_size, max(128, 1 << (n - 1).bit_length()))
    n_pad = -(-n // chunk_size) * chunk_size
    if n_pad != n:
        v = torch.cat([v, torch.zeros((n_pad - n, d), dtype=v.dtype, device=dev)])
    if two_stage:
        c = min(max(rescore_factor * k, k), n)
        if metric == "cosine":
            q = _normalize(q)
            v = _normalize(v)
        m = "l2" if metric == "l2" else "ip"
        bias = make_bias(n, n_pad, m, v)
        scores, idx = _two_stage(q, v.to(torch.bfloat16), v, bias, k, c, m)
    else:
        scores, idx = _exact_topk_scan(q, v, n, k, metric, chunk_size)
    return scores.cpu().numpy(), idx.cpu().numpy()
