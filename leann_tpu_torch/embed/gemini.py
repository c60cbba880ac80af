"""Gemini embedding provider via generativelanguage.googleapis.com
(:embedContent / :batchEmbedContents, batch 100), matching the reference's
GOOGLE_API_KEY/GEMINI_API_KEY resolution (`src/embedding/gemini.rs:64-179`).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from leann_tpu_torch.embed.httpx import post_json

BATCH_SIZE = 100
BASE = "https://generativelanguage.googleapis.com/v1beta"


class GeminiEmbedding:
    def __init__(
        self,
        model: str = "text-embedding-004",
        api_key: Optional[str] = None,
        base_url: Optional[str] = None,
    ):
        self.model = model
        self.api_key = (
            api_key
            or os.environ.get("GOOGLE_API_KEY")
            or os.environ.get("GEMINI_API_KEY", "")
        )
        self.base_url = (base_url or BASE).rstrip("/")
        self.dimensions = 768

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out: List[List[float]] = []
        model = self.model if self.model.startswith("models/") else f"models/{self.model}"
        for i in range(0, len(texts), BATCH_SIZE):
            batch = list(texts[i : i + BATCH_SIZE])
            resp = post_json(
                f"{self.base_url}/{model}:batchEmbedContents?key={self.api_key}",
                {
                    "requests": [
                        {"model": model, "content": {"parts": [{"text": t}]}}
                        for t in batch
                    ]
                },
            )
            out.extend(e["values"] for e in resp["embeddings"])
        arr = np.asarray(out, dtype=np.float32)
        if arr.size:
            self.dimensions = arr.shape[1]
        return arr
