"""Packed graph format for the graph traversal engine.

Replaces the reference's opaque native index binaries (usearch `.index`,
diskann `.diskann` — reference `src/backend/hnsw.rs:133`,
`src/backend/diskann.rs:86`) with a format designed for direct device upload:
a fixed-degree, padded adjacency matrix (int32 [N, R], pad = N i.e. one
past the last valid row — the traversal kernels keep a sentinel row of
zero vectors at index N), plus the entry point (medoid) and metric.
"""

from __future__ import annotations

import numpy as np


def graph_path(base: str) -> str:
    return base + ".graph.npz"


class GraphFile:
    def __init__(self, adjacency: np.ndarray, medoid: int, metric: str = "ip"):
        adjacency = np.asarray(adjacency, dtype=np.int32)
        if adjacency.ndim != 2:
            raise ValueError("adjacency must be [N, R]")
        self.adjacency = adjacency
        self.medoid = int(medoid)
        self.metric = metric

    @property
    def n(self) -> int:
        return self.adjacency.shape[0]

    @property
    def degree(self) -> int:
        return self.adjacency.shape[1]

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            adjacency=self.adjacency,
            medoid=np.int32(self.medoid),
            metric=np.array(self.metric),
        )

    @staticmethod
    def load(path: str) -> "GraphFile":
        with np.load(path, allow_pickle=False) as z:
            return GraphFile(
                adjacency=z["adjacency"],
                medoid=int(z["medoid"]),
                metric=str(z["metric"]),
            )

    @staticmethod
    def exists(base: str) -> bool:
        import os

        return os.path.exists(graph_path(base))
