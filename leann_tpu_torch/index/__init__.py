"""Index engine: build / search / rank."""

from leann_tpu_torch.index.bm25 import Bm25Scorer, hybrid_rerank, tokenize
from leann_tpu_torch.index.filter import MetadataFilter
from leann_tpu_torch.index.builder import IndexBuilder, StreamingIndexBuilder
from leann_tpu_torch.index.searcher import IndexSearcher, SearchOptions, SearchResult
from leann_tpu_torch.index.recompute import GraphRecomputeSearcher, RecomputeSearcher

__all__ = [
    "Bm25Scorer",
    "hybrid_rerank",
    "tokenize",
    "MetadataFilter",
    "IndexBuilder",
    "StreamingIndexBuilder",
    "IndexSearcher",
    "SearchOptions",
    "SearchResult",
    "GraphRecomputeSearcher",
    "RecomputeSearcher",
]
