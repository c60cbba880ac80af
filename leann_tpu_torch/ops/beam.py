"""Frontier-batched best-first beam search over a fixed-degree graph
(port of the stored-vector half of `leann_tpu/ops/beam.py`).

A batch of queries advances in lockstep. Each hop:

  1. every query picks its E best not-yet-expanded beam entries
  2. those nodes' fixed-degree neighbour rows are gathered      [B, E*R]
  3. candidates are scored by a pluggable expand function (row gather
     against the f32 corpus, or the int8/bf16 inline blocks)
  4. candidates are deduped (in-beam check + hashed visited table) and
     merged into the beam by a stable descending sort

This is plain PyTorch on both devices; the serving fast path on CUDA is
the fused kernel (`ops/fused_beam.py`). The loop exits when no query has
an unexpanded live entry or at max_iters.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from leann_tpu_torch.device import DeviceLike, free_device_bytes, resolve_device

NEG_INF = float("-inf")
HASH_MULT = 2654435761  # Knuth multiplicative hash (uint32)
_MASK32 = 0xFFFFFFFF


def _hash_slot(ids: torch.Tensor, hash_bits: int) -> torch.Tensor:
    """`(uint32(ids) * HASH_MULT mod 2**32) >> (32 - hash_bits)`.

    Computed in int64 on 16-bit halves so no product exceeds 2**49: the
    reference's uint32 multiply wraps, and a plain int64 product of two
    32-bit values can overflow 2**63."""
    x = ids.to(torch.int64) & _MASK32
    lo = x & 0xFFFF
    hi = x >> 16
    h = (lo * HASH_MULT + (((hi * HASH_MULT) & 0xFFFF) << 16)) & _MASK32
    return h >> (32 - hash_bits)


def _beam_search_core(
    queries: torch.Tensor,     # [B, D] f32
    r: int,                    # graph degree (candidates per expansion)
    entry: torch.Tensor,       # [] / [S] / [B, S] entry node ids
    exclude: torch.Tensor,     # [B] id never admitted (-1 = none)
    expand_fn: Callable[[torch.Tensor, torch.Tensor],
                        Tuple[torch.Tensor, torch.Tensor]],
    entry_score_fn: Optional[Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor]],
    n_sentinel: int,
    beam_width: int,
    max_iters: int,
    hash_bits: int = 12,
    expansions: int = 1,
    track_visited: int = 0,
    entry_scores: Optional[torch.Tensor] = None,  # [B, S] precomputed
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """expand_fn(queries, u [B, E]) -> (nbrs [B, E*R] ids, scores
    [B, E*R] f32). Returns (beam_ids [B, L] desc-sorted, beam_scores,
    vlog_ids [B, T], vlog_scores [B, T]); T = max(track_visited, E)
    records the first T expanded nodes per query (the Vamana visited
    set)."""
    b = queries.shape[0]
    dev = queries.device
    L = beam_width
    E = max(1, min(expansions, L))
    H = 1 << hash_bits
    T = max(track_visited, E)

    entries = torch.as_tensor(entry, dtype=torch.int64, device=dev)
    if entries.ndim == 0:
        entries = entries[None]
    if entries.ndim == 1:
        entry_rows = entries[None, :].expand(b, -1)
    else:
        entry_rows = entries
    s_n = entry_rows.shape[1]
    if entry_scores is None:
        entry_scores = entry_score_fn(queries, entry_rows)       # [B, S]
    beam_ids = torch.full((b, L), n_sentinel, dtype=torch.int64, device=dev)
    beam_ids[:, :s_n] = entry_rows
    # entries keep their real scores even when excluded; `exclude` only
    # gates candidate admission
    beam_scores = torch.full((b, L), NEG_INF, dtype=torch.float32, device=dev)
    beam_scores[:, :s_n] = entry_scores.float()
    expanded = torch.zeros((b, L), dtype=torch.bool, device=dev)
    visited = torch.full((b, H), -1, dtype=torch.int64, device=dev)
    visited.scatter_(1, _hash_slot(entry_rows, hash_bits), entry_rows)

    vlog_ids = torch.full((b, T), n_sentinel, dtype=torch.int64, device=dev)
    vlog_scores = torch.full((b, T), NEG_INF, dtype=torch.float32, device=dev)
    exclude = exclude.to(torch.int64)
    c = E * r
    lower = (torch.arange(c, device=dev)[None, :]
             < torch.arange(c, device=dev)[:, None])        # [i, j]: j < i

    for it in range(max_iters):
        mask = (~expanded) & (beam_ids != n_sentinel) & (beam_scores > NEG_INF)
        if not bool(mask.any()):
            break
        sel_scores = torch.where(mask, beam_scores, NEG_INF)
        top_sel, u_pos = torch.sort(sel_scores, dim=1, descending=True,
                                    stable=True)
        top_sel, u_pos = top_sel[:, :E], u_pos[:, :E]         # [B, E]
        active = top_sel > NEG_INF
        u = torch.gather(beam_ids, 1, u_pos)
        u = torch.where(active, u, 0)

        if track_visited > 0:
            cols = it * E + torch.arange(E, device=dev)
            keep = active & (cols[None, :] < T)
            if bool(keep.any()):
                safe = cols.clamp_max(T - 1)[None, :].expand(b, -1)
                vlog_ids.scatter_(1, safe, torch.where(
                    keep, u, torch.gather(vlog_ids, 1, safe)))
                vlog_scores.scatter_(1, safe, torch.where(
                    keep, top_sel, torch.gather(vlog_scores, 1, safe)))

        hit = torch.zeros_like(expanded)
        hit.scatter_(1, u_pos, active)
        expanded = expanded | hit

        nbrs, cand_scores = expand_fn(queries, u)             # [B, E*R]
        nbrs = nbrs.to(torch.int64)
        cand_active = active.repeat_interleave(r, dim=1)

        valid = (nbrs != n_sentinel) & cand_active
        valid &= nbrs != exclude[:, None]
        dup = (nbrs[:, :, None] == nbrs[:, None, :]) & lower[None]
        valid &= ~dup.any(dim=2)
        valid &= ~(nbrs[:, :, None] == beam_ids[:, None, :]).any(dim=2)
        slots = _hash_slot(nbrs, hash_bits)
        old = torch.gather(visited, 1, slots)
        valid &= ~(old == nbrs)
        visited.scatter_(1, slots, torch.where(valid, nbrs, old))

        cand_scores = torch.where(valid, cand_scores.float(), NEG_INF)
        cand_ids = torch.where(valid, nbrs, n_sentinel)

        all_scores = torch.cat([beam_scores, cand_scores], dim=1)
        all_ids = torch.cat([beam_ids, cand_ids], dim=1)
        all_exp = torch.cat([expanded, torch.zeros_like(valid)], dim=1)
        beam_scores, pos = torch.sort(all_scores, dim=1, descending=True,
                                      stable=True)
        beam_scores, pos = beam_scores[:, :L], pos[:, :L]
        beam_ids = torch.gather(all_ids, 1, pos)
        expanded = torch.gather(all_exp, 1, pos)
    return beam_ids, beam_scores, vlog_ids, vlog_scores


# ---------------------------------------------------------------- stored-vector


def beam_search_batch(
    queries: torch.Tensor,      # [B, D] f32
    vectors: torch.Tensor,      # [N+1, D] f32, row N = zeros (sentinel)
    adjacency: torch.Tensor,    # [N+1, R] int, pad = N
    sq_norms: torch.Tensor,     # [N+1] f32
    entry,
    exclude: torch.Tensor,
    beam_width: int,
    max_iters: int,
    metric: str,
    hash_bits: int = 12,
    expansions: int = 1,
    precision: str = "highest",
    track_visited: int = 0,
    seed_ids=None,
    n_entries: int = 16,
) -> Tuple[torch.Tensor, ...]:
    """Returns (beam_ids, beam_scores); with track_visited=T > 0 also
    (vlog_ids [B, T], vlog_scores [B, T]).

    `precision` is kept for the reference's signature: the port scores
    in full float32 for both "highest" and "default" (the reference's
    "default" is single-pass bf16 on a TPU and float32 on a CPU)."""
    del precision
    n_sentinel = vectors.shape[0] - 1

    def score_fn(q, ids):
        dots = torch.einsum("bkd,bd->bk", vectors[ids], q)
        if metric == "l2":
            return 2.0 * dots - sq_norms[ids]
        return dots

    def expand_fn(q, u):
        nbrs = adjacency[u].reshape(q.shape[0], -1).to(torch.int64)
        return nbrs, score_fn(q, nbrs)

    entry_sc = None
    if seed_ids is not None:
        seed_ids = seed_ids.to(torch.int64)
        seed_dots = queries @ vectors[seed_ids].T              # [B, M]
        if metric == "l2":
            seed_scores = 2.0 * seed_dots - sq_norms[seed_ids][None, :]
        else:
            seed_scores = seed_dots
        s_eff = min(n_entries, seed_ids.shape[0])
        entry_sc, best = torch.sort(seed_scores, dim=1, descending=True,
                                    stable=True)
        entry_sc, best = entry_sc[:, :s_eff], best[:, :s_eff]
        entry = seed_ids[best]
    out = _beam_search_core(
        queries, adjacency.shape[1], entry, exclude, expand_fn, score_fn,
        n_sentinel, beam_width, max_iters, hash_bits, expansions,
        track_visited, entry_scores=entry_sc,
    )
    return out if track_visited > 0 else out[:2]


# ------------------------------------------------------------ inline blocks
#
# Every node stores its R neighbours' vectors inline (int8 row-quantized
# or bf16), plus the dequant scale and |v|^2 per inlined row, so one hop
# reads E contiguous [R, D] blocks instead of E*R scattered rows. The
# final beam is rescored against the full-precision corpus.


def build_inline_blocks(
    vectors: torch.Tensor,    # [N+1, D] f32 (sentinel row = zeros)
    adjacency: torch.Tensor,  # [N+1, R] int
    dtype: str = "int8",      # "int8" | "bf16"
    chunk: int = 131072,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Returns (blocks [N+1, R, D] int8|bf16, scale_in [N+1, R] f32 or
    None, nsq_in [N+1, R] f32), built in row chunks."""
    n1, d = vectors.shape
    r = adjacency.shape[1]
    adj = adjacency.to(torch.int64)
    nsq = (vectors * vectors).sum(1)
    if dtype == "int8":
        scale = torch.clamp_min(vectors.abs().amax(1), 1e-12) / 127.0
        src = torch.clamp(torch.round(vectors / scale[:, None]), -127, 127).to(
            torch.int8)
        scale_in = scale[adj]
    else:
        src = vectors.to(torch.bfloat16)
        scale_in = None
    nsq_in = nsq[adj]
    blocks = torch.empty((n1, r, d), dtype=src.dtype, device=vectors.device)
    for i in range(0, n1, chunk):
        blocks[i : i + chunk] = src[adj[i : i + chunk]]
    return blocks, scale_in, nsq_in


def beam_search_inline_batch(
    queries: torch.Tensor,     # [B, D] f32
    corpus: torch.Tensor,      # [N+1, D] f32 (rescore source)
    adjacency: torch.Tensor,   # [N+1, R] int, pad = N
    blocks: torch.Tensor,      # [N+1, R, D] int8|bf16
    scale_in,                  # [N+1, R] f32 | None
    nsq_in: torch.Tensor,      # [N+1, R] f32
    corpus_nsq: torch.Tensor,  # [N+1] f32
    seed_ids: torch.Tensor,    # [M] int
    seed_vecs: torch.Tensor,   # [M, D] bf16
    exclude: torch.Tensor,     # [B]
    beam_width: int,
    max_iters: int,
    metric: str,
    hash_bits: int = 12,
    expansions: int = 2,
    n_entries: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serving-grade graph search: inline-block traversal + exact f32
    rescore. Returns (beam_ids [B, L], rescored beam_scores [B, L])."""
    b = queries.shape[0]
    n_sentinel = corpus.shape[0] - 1
    q_bf = queries.to(torch.bfloat16).float()
    seed_ids = seed_ids.to(torch.int64)
    entry_sc, entry = _seed_entries(
        q_bf, seed_vecs, seed_ids, corpus_nsq, metric, n_entries)

    def expand_fn(q, u):
        nbrs = adjacency[u].reshape(b, -1).to(torch.int64)     # [B, E*R]
        blk = blocks[u].float()                                # [B, E, R, D]
        dots = torch.einsum("berd,bd->ber", blk, q_bf).reshape(b, -1)
        if scale_in is not None:
            dots = dots * scale_in[u].reshape(b, -1)
        if metric == "l2":
            return nbrs, 2.0 * dots - nsq_in[u].reshape(b, -1)
        return nbrs, dots

    beam_ids, _, _, _ = _beam_search_core(
        queries, adjacency.shape[1], entry, exclude, expand_fn,
        None, n_sentinel, beam_width, max_iters, hash_bits,
        expansions, 0, entry_scores=entry_sc,
    )
    return _rescore(queries, corpus, corpus_nsq, beam_ids, n_sentinel,
                    metric, beam_ids.shape[1])


def _seed_entries(q_bf, seed_vecs, seed_ids, corpus_nsq, metric, n_entries):
    """Query-adaptive entries: one bf16-operand matmul over the seed
    pool, float32 accumulation (operands upcast after the bf16 rounding
    so the product is not itself rounded to bf16). Returns (entry
    scores [B, S], entry ids [B, S])."""
    seed_dots = q_bf.float() @ seed_vecs.float().T          # [B, M]
    if metric == "l2":
        seed_scores = 2.0 * seed_dots - corpus_nsq[seed_ids][None, :]
    else:
        seed_scores = seed_dots
    s_eff = min(n_entries, seed_ids.shape[0])
    entry_sc, best = torch.sort(seed_scores, dim=1, descending=True,
                                stable=True)
    return entry_sc[:, :s_eff], seed_ids[best[:, :s_eff]]


def _rescore(queries, corpus, corpus_nsq, cand, n_sentinel, metric, k_out,
             exclude=None, row_scale=None):
    """Exact f32 rescore of candidate ids [B, C] -> top k_out (ids,
    scores), sentinel (and `exclude`) entries at -inf. `row_scale` [N+1]
    dequantizes a row-quantized int8 corpus inside the gather."""
    rows = corpus[cand].float()                              # [B, C, D]
    if row_scale is not None:
        rows = rows * row_scale[cand][:, :, None]
    dots = torch.einsum("bld,bd->bl", rows, queries.float())
    if metric == "l2":
        scores = 2.0 * dots - corpus_nsq[cand]
    else:
        scores = dots
    scores = torch.where(cand == n_sentinel, NEG_INF, scores)
    if exclude is not None:
        scores = torch.where(cand == exclude.to(cand.dtype)[:, None],
                             NEG_INF, scores)
    top_scores, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, pos = top_scores[:, :k_out], pos[:, :k_out]
    return torch.gather(cand, 1, pos), top_scores


# ---------------------------------------------------------------- host API


def seed_pool_size(n: int) -> int:
    """Entry-seed pool size shared by every traversal engine: 4096 floor
    (a region holding f of the corpus goes unseeded with probability
    ~exp(-f*pool)), 4*sqrt(n) beyond 1M, clamped to n. Override with
    LEANN_SEED_POOL."""
    env = os.environ.get("LEANN_SEED_POOL")
    if env:
        return int(min(int(env), max(1, n)))
    return int(min(max(4096, 4 * int(n ** 0.5)), max(1, n)))


def draw_seed_ids(n: int, medoid: int, seed: int = 0) -> np.ndarray:
    """The seed pool: the same numpy draws as the reference, so both
    packages start from the same ids."""
    rng = np.random.default_rng(seed)
    pool = seed_pool_size(n)
    seeds = rng.choice(n, size=pool, replace=False)
    return np.unique(np.concatenate([[medoid], seeds])).astype(np.int32)


class BeamSearchEngine:
    """Host-facing wrapper: owns the device-resident search state.

    block_mode picks the traversal layout:
      "auto"  - bf16 inline blocks on small corpora, int8 inline when they
                fit the memory budget, row-gather otherwise
      "int8" / "bf16" - force inline blocks at that dtype
      "none"  - row-gather traversal (exact f32 candidate scores)
    """

    # Inline-structure budgets. On CPU the reference's byte counts apply
    # unchanged (so the same inputs pick the same layout); on CUDA they
    # are the same shares (2/16 and 6.8/16) of the free device memory.
    INLINE_BUDGET_BYTES = int(6.8e9)
    BF16_BUDGET_BYTES = int(2e9)

    def __init__(
        self,
        vectors: np.ndarray,
        adjacency: np.ndarray,
        medoid: int,
        metric: str = "ip",
        max_iters: Optional[int] = None,
        hash_bits: int = 12,
        expansions: int = 2,
        block_mode: str = "auto",
        visited_pool: int = 128,
        device: DeviceLike = None,
    ):
        self.device = dev = resolve_device(device)
        self.visited_pool = visited_pool
        self.expansions = max(1, expansions)
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.n, self.d = vectors.shape
        self.metric_in = metric
        if metric == "cosine":
            vectors = vectors / (
                np.linalg.norm(vectors, axis=1, keepdims=True) + 1e-12
            )
            metric = "ip"
        self.metric = metric
        self.hash_bits = hash_bits
        self.max_iters = max_iters

        self.vectors = torch.from_numpy(
            np.concatenate([vectors, np.zeros((1, self.d), np.float32)])
        ).to(dev)
        adj = np.ascontiguousarray(adjacency, dtype=np.int32)
        r = adj.shape[1]
        if adj.shape[0] == self.n:
            adj = np.concatenate([adj, np.full((1, r), self.n, np.int32)])
        self.adjacency = torch.from_numpy(adj.astype(np.int64)).to(dev)
        self.sq_norms = (self.vectors * self.vectors).sum(1)
        self.medoid = int(medoid)
        self.seed_ids = torch.from_numpy(
            draw_seed_ids(self.n, medoid).astype(np.int64)).to(dev)
        self.seed_vecs = self.vectors[self.seed_ids].to(torch.bfloat16)
        self.entries = torch.tensor(self.medoid, device=dev)

        if block_mode == "auto":
            bf16_budget, int8_budget = self.BF16_BUDGET_BYTES, self.INLINE_BUDGET_BYTES
            if dev.type == "cuda":
                free = free_device_bytes(dev)
                bf16_budget, int8_budget = free // 8, int(free * 0.425)
            inline_b = (self.n + 1) * r * (self.d + 8)
            if (self.n + 1) * r * (2 * self.d + 4) <= bf16_budget:
                block_mode = "bf16"
            elif inline_b <= int8_budget:
                block_mode = "int8"
            else:
                block_mode = "none"
        self.block_mode = block_mode
        if block_mode in ("int8", "bf16"):
            self.blocks, self.scale_in, self.nsq_in = build_inline_blocks(
                self.vectors, self.adjacency, dtype=block_mode
            )
        else:
            self.blocks = self.scale_in = self.nsq_in = None

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        beam_width: int = 64,
        exclude: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (idx [B, k] with -1 padding, scores [B, k])."""
        ids, scores = self.search_beam(queries, beam_width, exclude)
        k = min(k, ids.shape[1])
        idx = ids[:, :k].cpu().numpy()
        sc = scores[:, :k].cpu().numpy()
        idx = np.where(idx == self.n, -1, idx)
        return idx, sc

    def _prep(self, queries, exclude):
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        if self.metric_in == "cosine":
            q = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-12)
        exc = np.full((b,), -1, dtype=np.int64)
        if exclude is not None:
            exc[:b] = np.asarray(exclude, dtype=np.int64)
        return (torch.from_numpy(q).to(self.device),
                torch.from_numpy(exc).to(self.device), b)

    def _max_iters(self, beam_width):
        return self.max_iters or (4 * beam_width) // self.expansions + 32

    def search_beam(
        self,
        queries: np.ndarray,
        beam_width: int = 64,
        exclude: Optional[np.ndarray] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full beam (ids, scores), best-first sorted."""
        q, exc, b = self._prep(queries, exclude)
        max_iters = self._max_iters(beam_width)
        n_entries = min(16, max(1, beam_width // 2))
        if self.blocks is not None:
            ids, scores = beam_search_inline_batch(
                q, self.vectors, self.adjacency, self.blocks, self.scale_in,
                self.nsq_in, self.sq_norms, self.seed_ids, self.seed_vecs,
                exc, beam_width=beam_width, max_iters=max_iters,
                metric=self.metric, hash_bits=self.hash_bits,
                expansions=self.expansions, n_entries=n_entries,
            )
        else:
            ids, scores = self._visited_search(
                q, exc, beam_width, max_iters, n_entries)
        return ids[:b], scores[:b]

    def _visited_search(self, q, exc, beam_width, max_iters, n_entries):
        """Row-gather traversal + visited-log merge: row-gather scores are
        exact f32, so merging the visited log into the top-k is free
        recall."""
        out = beam_search_batch(
            q, self.vectors, self.adjacency, self.sq_norms, self.entries,
            exc, beam_width=beam_width, max_iters=max_iters,
            metric=self.metric, hash_bits=self.hash_bits,
            expansions=self.expansions, track_visited=self.visited_pool,
            seed_ids=self.seed_ids, n_entries=n_entries,
        )
        if not self.visited_pool:
            return out[0], out[1]
        return _merge_visited(*out, self.n)

    def search_many_device(self, qs, k=10, beam_width=64):
        """[M, B, D] device-resident query batches -> (ids, scores)
        [M, B, k]. Row-gather mode only, as in the reference."""
        if self.blocks is not None:
            raise NotImplementedError(
                "search_many_device: row-gather mode only")
        mi = self._max_iters(beam_width)
        n_entries = min(16, max(1, beam_width // 2))
        exc = torch.full((qs.shape[1],), -1, dtype=torch.int64,
                         device=self.device)
        outs = [self._visited_search(q, exc, beam_width, mi, n_entries)
                for q in qs]
        return (torch.stack([o[0][:, :k] for o in outs]),
                torch.stack([o[1][:, :k] for o in outs]))


def _merge_visited(beam_ids, beam_sc, vlog_ids, vlog_sc, n_sentinel):
    """Top-|beam| over beam ++ visited-log by score (one consistent score
    space); duplicates carry identical scores and an id-sorted adjacency
    dedup keeps one."""
    cand = torch.cat([beam_ids, vlog_ids], dim=1)
    sc = torch.cat([beam_sc, vlog_sc], dim=1)
    cand_s, order = torch.sort(cand, dim=1, stable=True)
    sc_s = torch.gather(sc, 1, order)
    dup = torch.cat([torch.zeros_like(cand_s[:, :1], dtype=torch.bool),
                     cand_s[:, 1:] == cand_s[:, :-1]], dim=1)
    sc_s = torch.where(dup | (cand_s == n_sentinel), NEG_INF, sc_s)
    top_sc, pos = torch.sort(sc_s, dim=1, descending=True, stable=True)
    top_sc, pos = top_sc[:, :beam_ids.shape[1]], pos[:, :beam_ids.shape[1]]
    top_ids = torch.gather(cand_s, 1, pos)
    return torch.where(top_sc == NEG_INF, n_sentinel, top_ids), top_sc
