"""Embedding model registry: per-model prefixes / dims / normalization.

Same model table as the reference (`src/embedding/models.rs:33-125`):
asymmetric models need document vs query prefixes; version tags like
`:latest` are stripped before lookup.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ModelConfig:
    document_prefix: str = ""
    query_prefix: str = ""
    normalized: bool = False
    dimensions: int = 768


_NOMIC = ModelConfig(
    document_prefix="search_document: ",
    query_prefix="search_query: ",
    normalized=True,
    dimensions=768,
)
_MXBAI = ModelConfig(
    document_prefix="Represent this document for retrieval: ",
    query_prefix="Represent this sentence for searching relevant passages: ",
    normalized=True,
    dimensions=1024,
)
_BGE_QUERY_PREFIX = "Represent this sentence for searching relevant passages: "


def _size_dims(name: str, small: int = 384, large: int = 1024, base: int = 768) -> int:
    if "small" in name:
        return small
    if "large" in name:
        return large
    return base


def get_model_config(model_name: str) -> ModelConfig:
    base = model_name.split(":", 1)[0]

    if base in (
        "nomic-embed-text",
        "nomic-embed-text-v1",
        "nomic-embed-text-v1.5",
        "text-embedding-nomic-embed-text-v1.5",
    ):
        return _NOMIC
    if base in ("mxbai-embed-large", "mxbai-embed-large-v1"):
        return _MXBAI
    if base in (
        "bge-small-en", "bge-base-en", "bge-large-en",
        "bge-small-en-v1.5", "bge-base-en-v1.5", "bge-large-en-v1.5",
    ):
        return ModelConfig(
            document_prefix="",
            query_prefix=_BGE_QUERY_PREFIX,
            normalized=True,
            dimensions=_size_dims(base),
        )
    if base in (
        "e5-small", "e5-base", "e5-large",
        "e5-small-v2", "e5-base-v2", "e5-large-v2",
        "multilingual-e5-small", "multilingual-e5-base", "multilingual-e5-large",
    ):
        return ModelConfig(
            document_prefix="passage: ",
            query_prefix="query: ",
            normalized=True,
            dimensions=_size_dims(base),
        )
    if base in ("gte-small", "gte-base", "gte-large"):
        return ModelConfig(normalized=True, dimensions=_size_dims(base))
    if base in ("all-minilm", "all-MiniLM-L6-v2", "all-MiniLM-L12-v2"):
        return ModelConfig(normalized=True, dimensions=384)
    if base == "text-embedding-3-small":
        return ModelConfig(normalized=True, dimensions=1536)
    if base == "text-embedding-3-large":
        return ModelConfig(normalized=True, dimensions=3072)
    if base == "text-embedding-ada-002":
        return ModelConfig(normalized=True, dimensions=1536)
    return ModelConfig()
