"""IndexSearcher: batched query pipeline over a built index (port of
`leann_tpu/index/searcher.py`).

Over-fetch 5x, BM25-union hybrid with min-max alpha fusion, post-filter
during hydration, BM25-driven expansion for short queries. Queries are
batched [B, D] end to end; the ANN search runs on `device` (default
cuda) through the port's `load_searcher`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from leann_tpu_torch.backend import load_searcher
from leann_tpu_torch.index.bm25 import Bm25Scorer, bm25_path, hybrid_rerank
from leann_tpu_torch.index.filter import MetadataFilter
from leann_tpu_torch.index import query as queryexp
from leann_tpu_torch.store.meta import IndexMeta, meta_path
from leann_tpu_torch.store.passages import PassageStore, read_ids


@dataclass
class SearchOptions:
    top_k: int = 10
    complexity: int = 64
    filter: Optional[MetadataFilter] = None
    hybrid: bool = False
    hybrid_alpha: float = 0.7  # weight on vector scores (reference searcher.rs:47)
    query_text: Optional[str] = None  # needed for hybrid / expansion
    # Batched hybrid: one text PER ROW of the query batch, so many
    # hybrid requests can share a single device dispatch (the BM25
    # rescore is host-side and per-row anyway). A None row means "no
    # hybrid rescore for this row", letting plain and hybrid requests
    # share one dispatch too. Falls back to query_text for every row
    # when absent.
    query_texts: Optional[Sequence[Optional[str]]] = None
    expand: bool = False


@dataclass
class SearchResult:
    id: str
    score: float
    text: str
    metadata: Dict[str, Any] = field(default_factory=dict)


class IndexSearcher:
    def __init__(self, base: str, sharded: bool = False, device=None):
        self.base = base
        self.meta = IndexMeta.load(meta_path(base))
        self.passages = PassageStore(base)
        self.ids = read_ids(base)
        self.backend = load_searcher(base, self.meta, sharded=sharded,
                                     device=device)
        self._bm25: Optional[Bm25Scorer] = None
        self._bm25_checked = False

    @staticmethod
    def load(base: str, sharded: bool = False,
             device=None) -> "IndexSearcher":
        return IndexSearcher(base, sharded=sharded, device=device)

    def __len__(self) -> int:
        return len(self.ids)

    # ---------------- BM25 sidecar ----------------

    def bm25(self) -> Optional[Bm25Scorer]:
        if not self._bm25_checked:
            self._bm25_checked = True
            path = bm25_path(self.base)
            if os.path.exists(path):
                self._bm25 = Bm25Scorer.load(path)
            else:
                # Fallback: build in memory from the passage file (slow path,
                # matches reference behavior when no sidecar exists).
                texts = [None] * len(self.ids)
                pos = {pid: i for i, pid in enumerate(self.ids)}
                for p in self.passages.iter_all():
                    i = pos.get(p.id)
                    if i is not None:
                        texts[i] = p.text
                self._bm25 = Bm25Scorer.build([t or "" for t in texts])
        return self._bm25

    def bm25_search(self, query: str, top_k: int) -> List[SearchResult]:
        scorer = self.bm25()
        if scorer is None:
            return []
        out = []
        for int_id, score in scorer.search(query, top_k):
            res = self._hydrate(int_id, score)
            if res is not None:
                out.append(res)
        return out

    def expand_query(self, query: str, max_terms: int = 5) -> str:
        """BM25-driven expansion for short queries (reference
        search.rs:173-187 + query.rs:128-171)."""
        if not queryexp.should_expand(query):
            return query
        hits = self.bm25_search(query, 5)
        return queryexp.expand_from_passages(
            query, [h.text for h in hits], max_terms
        )

    # ---------------- main search ----------------

    def search(
        self, query_vectors: np.ndarray, options: Optional[SearchOptions] = None
    ) -> List[List[SearchResult]]:
        """Batched search: [B, D] (or [D]) -> per-query result lists."""
        from leann_tpu_torch.utils import METRICS

        options = options or SearchOptions()
        q = np.asarray(query_vectors, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        METRICS.inc("search.requests")
        METRICS.inc("search.queries", q.shape[0])
        return self._search_batch(q, options)

    def _search_batch(
        self, q: np.ndarray, options: SearchOptions
    ) -> List[List[SearchResult]]:
        from leann_tpu_torch.utils import span

        # Always overfetch: top-(5k) vs top-k costs one wider top-k over
        # the same traversal, and every request of a batch then shares
        # one shape. Plain results just truncate to top_k.
        fetch_k = min(options.top_k * 5, len(self.ids))
        if fetch_k == 0:
            return [[] for _ in range(q.shape[0])]

        with span("search.ann", backend=self.meta.backend_name, b=q.shape[0]):
            idx, scores = self.backend.search(
                q, k=fetch_k, complexity=max(options.complexity, fetch_k)
            )

        results: List[List[SearchResult]] = []
        for row in range(q.shape[0]):
            pairs = [
                (int(i), float(s))
                for i, s in zip(idx[row], scores[row])
                if i >= 0
            ]
            if options.hybrid:
                text = (
                    options.query_texts[row]
                    if options.query_texts is not None
                    else options.query_text
                )
                if text:
                    pairs = self._hybrid(pairs, options, text)
            hydrated: List[SearchResult] = []
            for int_id, score in pairs:
                res = self._hydrate(int_id, score)
                if res is None:
                    continue
                if options.filter is not None and not options.filter.matches(
                    res.metadata
                ):
                    continue
                hydrated.append(res)
                if len(hydrated) >= options.top_k:
                    break
            results.append(hydrated)
        return results

    def search_one(
        self, query_vector: np.ndarray, options: Optional[SearchOptions] = None
    ) -> List[SearchResult]:
        return self.search(np.asarray(query_vector), options)[0]

    # ---------------- helpers ----------------

    def _hybrid(self, pairs, options: SearchOptions, text: str):
        scorer = self.bm25()
        if scorer is None:
            return pairs
        bm25_scores = scorer.score_query(text)
        # Union in BM25 top hits not found by the vector path, with vector
        # score 0.0 (reference searcher.rs:154-165). Top-k comes from the
        # scores we already computed — calling scorer.search() here would
        # re-score every posting a second time (~2x the per-row hybrid
        # cost at serving time).
        have = {i for i, _ in pairs}
        nz = np.flatnonzero(bm25_scores > 0.0)
        if nz.size > options.top_k:
            nz = nz[np.argpartition(-bm25_scores[nz], options.top_k - 1)[
                :options.top_k]]
        for int_id in nz:
            if int(int_id) not in have:
                pairs.append((int(int_id), 0.0))
        return hybrid_rerank(pairs, bm25_scores, options.hybrid_alpha)

    def _hydrate(self, int_id: int, score: float) -> Optional[SearchResult]:
        if int_id < 0 or int_id >= len(self.ids):
            return None
        pid = self.ids[int_id]
        passage = self.passages.get(pid)
        if passage is None:
            return None
        return SearchResult(
            id=pid, score=score, text=passage.text, metadata=passage.metadata
        )
