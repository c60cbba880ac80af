"""Deterministic fake embedder for hermetic tests.

hash(text) seeds a PRNG that draws a unit-norm gaussian vector, so
identical texts map to identical embeddings and the whole
build -> search -> recall pipeline is testable with zero network and zero
model weights. (The reference has no fake embedding provider; its only
test double is SimulatedLlm — `src/llm/simulated.rs`.)
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np


class FakeEmbedding:
    def __init__(self, dimensions: int = 64):
        self.dimensions = dimensions
        self.model = "fake"

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = np.empty((len(texts), self.dimensions), dtype=np.float32)
        for i, text in enumerate(texts):
            digest = hashlib.sha256(text.encode("utf-8")).digest()
            seed = int.from_bytes(digest[:8], "little")
            rng = np.random.default_rng(seed)
            v = rng.standard_normal(self.dimensions).astype(np.float32)
            out[i] = v / (np.linalg.norm(v) + 1e-12)
        return out
