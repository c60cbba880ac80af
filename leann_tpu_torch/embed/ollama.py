"""Ollama embedding provider (`POST {host}/api/embed`), matching the
reference's host resolution LEANN_OLLAMA_HOST -> OLLAMA_HOST ->
localhost:11434 and batch size 32 (`src/embedding/ollama.rs:34-95`)."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from leann_tpu_torch.embed.httpx import post_json

BATCH_SIZE = 32

_KNOWN_DIMS = {
    "nomic-embed-text": 768,
    "mxbai-embed-large": 1024,
    "all-minilm": 384,
    "bge-m3": 1024,
    "snowflake-arctic-embed": 1024,
}


def resolve_host(host: Optional[str] = None) -> str:
    return (
        host
        or os.environ.get("LEANN_OLLAMA_HOST")
        or os.environ.get("OLLAMA_HOST")
        or "http://localhost:11434"
    ).rstrip("/")


class OllamaEmbedding:
    def __init__(
        self,
        model: str = "nomic-embed-text",
        host: Optional[str] = None,
        batch_size: int = BATCH_SIZE,
    ):
        self.model = model
        self.host = resolve_host(host)
        self.batch_size = batch_size
        self.dimensions = _KNOWN_DIMS.get(model.split(":")[0], 768)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out: List[List[float]] = []
        for i in range(0, len(texts), self.batch_size):
            batch = list(texts[i : i + self.batch_size])
            resp = post_json(
                f"{self.host}/api/embed",
                {"model": self.model, "input": batch},
            )
            out.extend(resp["embeddings"])
        arr = np.asarray(out, dtype=np.float32)
        if arr.size:
            self.dimensions = arr.shape[1]
        return arr
