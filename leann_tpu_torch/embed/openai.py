"""OpenAI-compatible embedding provider (also serves LM Studio via
base_url, like the reference — `src/embedding/openai.rs:39-104`).

Dims auto-detect: known models from the registry; unknown models probed
with a single embed call (reference openai.rs:57-74). Batches of 100.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from leann_tpu_torch.embed.httpx import post_json

BATCH_SIZE = 100

_KNOWN_DIMS = {
    "text-embedding-3-small": 1536,
    "text-embedding-3-large": 3072,
    "text-embedding-ada-002": 1536,
}


class OpenAIEmbedding:
    def __init__(
        self,
        model: str = "text-embedding-3-small",
        api_key: Optional[str] = None,
        base_url: Optional[str] = None,
        batch_size: int = BATCH_SIZE,
    ):
        self.model = model
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self.base_url = (
            base_url
            or os.environ.get("OPENAI_BASE_URL")
            or "https://api.openai.com/v1"
        ).rstrip("/")
        self.batch_size = batch_size
        self.dimensions = _KNOWN_DIMS.get(model.split(":")[0], 0)
        if self.dimensions == 0:
            self.dimensions = len(self._embed_batch(["dimension probe"])[0])

    def _embed_batch(self, texts: Sequence[str]) -> List[List[float]]:
        resp = post_json(
            f"{self.base_url}/embeddings",
            {"model": self.model, "input": list(texts)},
            headers={"Authorization": f"Bearer {self.api_key}"},
        )
        rows = sorted(resp["data"], key=lambda d: d.get("index", 0))
        return [r["embedding"] for r in rows]

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out: List[List[float]] = []
        for i in range(0, len(texts), self.batch_size):
            out.extend(self._embed_batch(texts[i : i + self.batch_size]))
        return np.asarray(out, dtype=np.float32)
