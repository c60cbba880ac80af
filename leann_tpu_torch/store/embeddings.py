"""Embeddings store: raw little-endian f32 row-major matrix file.

Same byte format as the reference (`src/index/embeddings.rs:13-159`):
no header — the row count is inferred from file size / (dim * 4).
Reads are np.memmap so multi-GB corpora page in lazily and can be
uploaded to device memory block-by-block.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def embeddings_path(base: str) -> str:
    return base + ".embeddings"


class EmbeddingsWriter:
    def __init__(self, base: str, dim: int, append: bool = False):
        self.base = base
        self.dim = dim
        self.count = 0
        mode = "ab" if append else "wb"
        if append and os.path.exists(embeddings_path(base)):
            size = os.path.getsize(embeddings_path(base))
            self.count = size // (dim * 4)
        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
        self._f = open(embeddings_path(base), mode)

    def add(self, rows: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows, dtype="<f4")
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {rows.shape[1]}")
        self._f.write(rows.tobytes())
        self.count += rows.shape[0]

    def finish(self) -> None:
        self._f.flush()
        self._f.close()

    def __enter__(self) -> "EmbeddingsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


class EmbeddingsStore:
    def __init__(self, base: str, dim: int):
        path = embeddings_path(base)
        size = os.path.getsize(path)
        if size % (dim * 4) != 0:
            raise ValueError(
                f"embeddings file size {size} not a multiple of dim {dim} * 4"
            )
        self.dim = dim
        self.count = size // (dim * 4)
        self.mmap: np.ndarray = np.memmap(
            path, dtype="<f4", mode="r", shape=(self.count, dim)
        )

    def __len__(self) -> int:
        return self.count

    def get(self, i: int) -> np.ndarray:
        return np.asarray(self.mmap[i])

    def all(self) -> np.ndarray:
        """The full matrix as a (lazily paged) array view."""
        return self.mmap

    @staticmethod
    def exists(base: str) -> bool:
        return os.path.exists(embeddings_path(base))


def prune_embeddings(base: str) -> Optional[int]:
    """Delete the embeddings file (LEANN pruning; reference
    `src/index/embeddings.rs:162-168`). Returns bytes freed or None."""
    path = embeddings_path(base)
    if not os.path.exists(path):
        return None
    size = os.path.getsize(path)
    os.remove(path)
    return size
