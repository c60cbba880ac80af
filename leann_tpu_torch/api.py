"""Library API: open an index and search it with text, in-process (port
of `leann_tpu/api.py`).

The reference is CLI-only (`src/main.rs`); embedded use cases
(notebooks, RAG pipelines, tests) need a Python-level surface. `Index`
wraps the pipeline the `search` command runs (reference
`src/cli/search.rs:73-257`): meta-driven provider, query prefix
templates, auto-hybrid for short queries, BM25 query expansion, and the
pruned -> recompute dispatch.

The port's one addition is `device=`: None means cuda, as at every entry
point of the port, and without CUDA the first call that needs the device
raises (`device.resolve_device`); pass `device="cpu"` to run the plain
PyTorch path. A list of devices (`["cpu"] * 8`) lays a sharded index's
shards over them; everything else (the unsharded searcher, the recompute
searchers, the provider's local encoder) runs on the list's first device.

    import leann_tpu_torch

    idx = leann_tpu_torch.Index.open("myidx")
    for hit in idx.search("how does the chunker work?", top_k=5):
        print(hit.score, hit.id, hit.text[:80])
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import numpy as np

from leann_tpu_torch.cli.common import (
    provider_from_meta,
    resolve_build_template,
    resolve_query_template,
)
from leann_tpu_torch.index import query as queryexp
from leann_tpu_torch.index.filter import MetadataFilter
from leann_tpu_torch.index.searcher import IndexSearcher, SearchOptions, SearchResult
from leann_tpu_torch.store.locate import find_index, index_base
from leann_tpu_torch.store.meta import IndexMeta, meta_path
from leann_tpu_torch.store.passages import read_ids

FilterLike = Union[None, str, MetadataFilter]


class Index:
    """An opened index: text queries in, scored passages out.

    Engines (graph / IVF / flat / sharded / pruned-recompute) are picked
    from the index's own metadata exactly as the CLI picks them; the
    first search pays the engine build (and on a card, the first use of
    each kernel builds it with nvcc), subsequent searches are steady-state.
    """

    def __init__(
        self,
        base: str,
        *,
        sharded: bool = False,
        api_key: Optional[str] = None,
        host: Optional[str] = None,
        base_url: Optional[str] = None,
        query_template: Optional[str] = None,
        device=None,
    ):
        self.base = base
        self.meta = IndexMeta.load(meta_path(base))
        self.device = device
        self.provider = provider_from_meta(
            self.meta, api_key=api_key, host=host, base_url=base_url,
            device=self._primary_device,
        )
        self.query_template = resolve_query_template(query_template, self.meta)
        self._sharded = sharded
        self._searcher: Optional[IndexSearcher] = None
        self._recompute = None  # pruned-path searcher (either variant)

    @classmethod
    def open(cls, name_or_path: str, **kwargs) -> "Index":
        """Open by index name (resolved like the CLI: `.leann/indexes/`
        under the cwd, then a literal directory path, then
        `~/.leann/indexes/`) or by a direct path to the index dir."""
        return cls(index_base(find_index(name_or_path)), **kwargs)

    @property
    def _primary_device(self):
        """The one device of everything but the sharded mesh."""
        if isinstance(self.device, (list, tuple)):
            return self.device[0]
        return self.device

    # ---------------- introspection ----------------

    @property
    def is_pruned(self) -> bool:
        return bool(self.meta.is_pruned)

    @property
    def backend_name(self) -> str:
        return self.meta.backend_name

    def __len__(self) -> int:
        return len(read_ids(self.base))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"Index(base={self.base!r}, backend={self.meta.backend_name}, "
            f"n={len(self)}, pruned={self.is_pruned}, device={self.device!r})"
        )

    # ---------------- lazily-built engines ----------------

    def _stored_searcher(self) -> IndexSearcher:
        if self._searcher is None:
            self._searcher = IndexSearcher.load(
                self.base, sharded=self._sharded,
                device=self.device if self._sharded else self._primary_device,
            )
        return self._searcher

    def _recompute_searcher(self):
        if self._recompute is None:
            from leann_tpu_torch.store.graphfile import GraphFile
            from leann_tpu_torch.store.tokens import tokens_exist

            if (
                self.meta.embedding_mode == "local"
                and GraphFile.exists(self.base)
                and tokens_exist(self.base)
            ):
                from leann_tpu_torch.index.recompute import GraphRecomputeSearcher

                # the provider's encoder was built on the same device
                self._recompute = GraphRecomputeSearcher(
                    self.base, self.provider._impl.encoder,
                    device=self._primary_device,
                )
            else:
                from leann_tpu_torch.index.recompute import RecomputeSearcher

                self._recompute = RecomputeSearcher(
                    self.base,
                    self.provider,
                    document_template=resolve_build_template(
                        self.meta, self.provider
                    ),
                    device=self._primary_device,
                )
        return self._recompute

    # ---------------- embedding ----------------

    def embed(self, texts: List[str]) -> np.ndarray:
        """Embed query texts with the index's provider + query template."""
        return np.asarray(
            self.provider.embed_with_template(list(texts), self.query_template)
        )

    # ---------------- search ----------------

    def search(
        self,
        query: str,
        top_k: int = 5,
        complexity: int = 64,
        filter: FilterLike = None,
        hybrid: Optional[bool] = None,
        hybrid_alpha: float = 0.7,
        expand: bool = True,
        on_expand: Optional[Callable[[str], None]] = None,
    ) -> List[SearchResult]:
        """Text search. `hybrid=None` auto-enables vector+BM25 fusion for
        short (<= 3 word) queries, like the CLI; `expand` applies BM25
        query expansion to short queries. `filter` takes a DSL string
        (e.g. ``"source:*.rs AND type=code"``) or a parsed
        MetadataFilter. `on_expand` is called with the rewritten query
        when expansion fires (the CLI prints it to stderr)."""
        filt = (
            MetadataFilter.parse(filter) if isinstance(filter, str) else filter
        )
        if hybrid is None:
            hybrid = queryexp.should_expand(query)

        if self.is_pruned:
            qvec = self.embed([query])[0]
            rs = self._recompute_searcher()
            from leann_tpu_torch.index.recompute import GraphRecomputeSearcher

            if isinstance(rs, GraphRecomputeSearcher):
                return rs.search(
                    qvec, top_k=top_k, complexity=complexity, filter=filt
                )
            return rs.search(qvec, top_k=top_k, filter=filt)

        searcher = self._stored_searcher()
        if expand and queryexp.should_expand(query):
            expanded = searcher.expand_query(query)
            if expanded != query:
                if on_expand is not None:
                    on_expand(expanded)
                query = expanded
        qvec = self.embed([query])
        return searcher.search(
            qvec,
            SearchOptions(
                top_k=top_k,
                complexity=complexity,
                filter=filt,
                hybrid=hybrid,
                hybrid_alpha=hybrid_alpha,
                query_text=query,
            ),
        )[0]

    def search_vectors(
        self,
        query_vectors: np.ndarray,
        top_k: int = 10,
        complexity: int = 64,
        filter: FilterLike = None,
    ) -> List[List[SearchResult]]:
        """Batched vector search: [B, D] (or [D]) -> per-query results.
        The throughput path: all queries advance in one batched engine
        dispatch. Not available on pruned indexes opened without their
        encoder (use `search`)."""
        filt = (
            MetadataFilter.parse(filter) if isinstance(filter, str) else filter
        )
        q = np.asarray(query_vectors, dtype=np.float32)
        if self.is_pruned:
            from leann_tpu_torch.index.recompute import GraphRecomputeSearcher

            rs = self._recompute_searcher()
            if q.ndim == 1:
                q = q[None, :]
            if isinstance(rs, GraphRecomputeSearcher):
                return [
                    rs.search(v, top_k=top_k, complexity=complexity, filter=filt)
                    for v in q
                ]
            return [rs.search(v, top_k=top_k, filter=filt) for v in q]
        return self._stored_searcher().search(
            q,
            SearchOptions(top_k=top_k, complexity=complexity, filter=filt),
        )


def open_index(name_or_path: str, **kwargs) -> Index:
    """Shorthand for :meth:`Index.open`."""
    return Index.open(name_or_path, **kwargs)
