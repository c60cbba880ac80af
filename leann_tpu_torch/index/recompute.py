"""Pruned-index search: recompute embeddings at query time (port of
`leann_tpu/index/recompute.py`).

LEANN's signature mode (reference `src/index/recompute.rs:17-134`): the
embeddings file has been deleted; only passages and ids (and optionally
the graph and the token sidecar) remain. Search re-embeds passages on
demand, on `device` (default cuda).

Two engines:
  - brute force (`RecomputeSearcher`): filter early, re-embed every
    surviving passage in batches, exact top-k on the device.
  - graph traversal (`GraphRecomputeSearcher`) with hop-synchronous
    re-embedding of the frontier (`ops/beam.py: RecomputeBeamEngine`),
    for large corpora.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from leann_tpu_torch.device import DeviceLike
from leann_tpu_torch.index.filter import MetadataFilter
from leann_tpu_torch.index.searcher import SearchResult
from leann_tpu_torch.ops.distance import exact_topk
from leann_tpu_torch.store.meta import IndexMeta, meta_path
from leann_tpu_torch.store.passages import PassageStore, read_ids

RECOMPUTE_BATCH = 100  # reference recompute.rs:86-93


class GraphRecomputeSearcher:
    """Pruned graph index + token store: frontier-batched traversal with
    on-device re-embedding. Only the nodes the traversal visits get
    re-embedded, not the whole corpus. `encoder` is a
    `models.bert.BertEncoder` on `device`."""

    def __init__(self, base: str, encoder, device: DeviceLike = None):
        from leann_tpu_torch.ops.beam import RecomputeBeamEngine
        from leann_tpu_torch.store.graphfile import GraphFile, graph_path
        from leann_tpu_torch.store.tokens import load_tokens

        self.base = base
        self.meta = IndexMeta.load(meta_path(base))
        self.passages = PassageStore(base)
        self.ids = read_ids(base)
        graph = GraphFile.load(graph_path(base))
        token_ids, attn_mask = load_tokens(base)
        self.engine = RecomputeBeamEngine(
            token_ids, attn_mask, graph.adjacency, graph.medoid,
            encoder, metric=self.meta.metric, device=device,
        )

    def search(
        self,
        query_vector: np.ndarray,
        top_k: int = 10,
        complexity: int = 32,
        filter: Optional[MetadataFilter] = None,
    ) -> List[SearchResult]:
        fetch_k = top_k * 5 if filter is not None else top_k
        idx, scores = self.engine.search(
            query_vector, k=min(fetch_k, len(self.ids)),
            beam_width=max(complexity, top_k),
        )
        out: List[SearchResult] = []
        for i, s in zip(idx[0], scores[0]):
            if i < 0 or i >= len(self.ids):
                continue
            p = self.passages.get(self.ids[int(i)])
            if p is None:
                continue
            if filter is not None and not filter.matches(p.metadata):
                continue
            out.append(
                SearchResult(id=p.id, score=float(s), text=p.text,
                             metadata=p.metadata)
            )
            if len(out) >= top_k:
                break
        return out


class RecomputeSearcher:
    """Brute force over a pruned index. `provider` has
    `embed_with_template(texts, template) -> [n, D]`."""

    def __init__(self, base: str, provider,
                 document_template: Optional[str] = None,
                 device: DeviceLike = None):
        self.base = base
        self.meta = IndexMeta.load(meta_path(base))
        self.passages = PassageStore(base)
        self.ids = read_ids(base)
        self.provider = provider
        self.document_template = document_template
        self.device = device

    def search(
        self,
        query_vector: np.ndarray,
        top_k: int = 10,
        filter: Optional[MetadataFilter] = None,
        batch_size: int = RECOMPUTE_BATCH,
    ) -> List[SearchResult]:
        # Filter early so excluded passages are never embedded
        # (reference recompute.rs:65-79).
        surviving = [p for p in self.passages.iter_all()
                     if filter is None or filter.matches(p.metadata)]
        if not surviving:
            return []

        rows = []
        for i in range(0, len(surviving), batch_size):
            batch = surviving[i : i + batch_size]
            rows.append(
                self.provider.embed_with_template(
                    [p.text for p in batch], self.document_template
                )
            )
        vectors = np.concatenate(rows, axis=0)

        metric = getattr(self.meta, "metric", "ip")
        k = min(top_k, len(surviving))
        scores, idx = exact_topk(query_vector, vectors, k, metric=metric,
                                 device=self.device)
        out: List[SearchResult] = []
        for i, s in zip(idx[0], scores[0]):
            if i < 0:
                continue
            p = surviving[int(i)]
            out.append(
                SearchResult(id=p.id, score=float(s), text=p.text,
                             metadata=p.metadata)
            )
        return out
