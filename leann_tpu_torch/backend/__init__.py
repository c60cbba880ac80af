"""ANN backends (port of `leann_tpu/backend/__init__.py`).

  flat    exact matmul + top-k (the recall oracle)
  vamana  fixed-degree graph + beam search (aliases "hnsw" and "diskann")
  ivf     not in this slice: raises NotImplementedError (ROADMAP Queue A,
          the IVF family)

A searcher takes a *batch* of query vectors. Every searcher runs on
`device` (default cuda; see `leann_tpu_torch.device`).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from leann_tpu_torch.device import (
    DeviceLike, free_device_bytes, kernels_available, resolve_device,
)

ALIASES = {"hnsw": "vamana", "diskann": "vamana", "exact": "flat"}
BACKENDS = ("flat", "vamana", "ivf")


def resolve_backend(name: str) -> str:
    name = (name or "flat").lower()
    name = ALIASES.get(name, name)
    if name not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; expected one of {BACKENDS} "
            f"(aliases: {sorted(ALIASES)})"
        )
    return name


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to leann_tpu_torch yet (ROADMAP: {item})")


def _pq_planes(r: int, m: int) -> int:
    """Record planes of the reference's 8-bit PQ layout
    (`leann_tpu/ops/pq_beam.py:pq_layout`): plane 0 holds the R ids, then
    m subspaces of R/4 lanes each, none crossing a 128-lane plane."""
    lps, plane, off = r // 4, 0, r
    for _ in range(m):
        if off + lps > 128:
            plane, off = plane + 1, 0
        off += lps
    return plane + 1


class FlatSearcher:
    """Exact search over the embeddings matrix, served by the
    device-resident two-stage engine (bf16 scan + f32 rescore)."""

    def __init__(self, vectors: np.ndarray, metric: str = "ip",
                 device: DeviceLike = None):
        from leann_tpu_torch.ops.distance import ExactEngine

        self.metric = metric
        self.engine = ExactEngine(np.asarray(vectors), metric=metric,
                                  device=device)

    def __len__(self) -> int:
        return self.engine.n

    def search(
        self, queries: np.ndarray, k: int, complexity: int = 64
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (idx [B,k], scores [B,k]); complexity is ignored."""
        return self.engine.search(queries, k=k)


class GraphSearcher:
    """Beam search over a fixed-degree graph.

    Engine selection (override with LEANN_GRAPH_ENGINE=fused|inline|pq):
    on CUDA with kernel shapes (D % 128 == 0, R <= 128) and int8 blocks
    within 9/16 of the free device memory (the reference's 9 GB of a
    16 GB v5e), the fused CUDA traversal serves. Where the reference
    would fall through to PQ records, the port raises until the PQ slice
    lands. Otherwise (and always on CPU under "auto") the plain inline /
    row-gather engine serves."""

    def __init__(self, vectors: np.ndarray, graph, metric: str = "ip",
                 base: str = "", device: DeviceLike = None):
        self.metric = metric
        dev = resolve_device(device)
        vectors = np.asarray(vectors)
        n, d = vectors.shape
        r = graph.adjacency.shape[1]
        choice = os.environ.get("LEANN_GRAPH_ENGINE", "auto")
        use_fused = False
        if choice == "auto":
            if kernels_available(dev) and r <= 128:
                free = free_device_bytes(dev)
                use_fused = d % 128 == 0 and (n + 1) * r * d < free * (9 / 16)
                m = next((mm for mm in (16, 12, 8) if d % mm == 0), 0)
                if not use_fused and m and r % 4 == 0 and \
                        (n + 1) * _pq_planes(r, m) * 512 + n * d * 2 < \
                        free * (13 / 16):
                    raise _not_ported(
                        "the PQ graph engine (chosen when int8 inline blocks "
                        "do not fit or D % 128 != 0)", "Queue A 10, PQ")
        elif choice == "pq":
            raise _not_ported("LEANN_GRAPH_ENGINE=pq", "Queue A 10, PQ")
        else:
            use_fused = choice == "fused"
        if use_fused:
            from leann_tpu_torch.ops.fused_beam import FusedBeamEngine

            self.engine = FusedBeamEngine(
                vectors=vectors,
                adjacency=graph.adjacency,
                medoid=graph.medoid,
                metric=metric,
                expansions=2,
                qb=int(os.environ.get("LEANN_FUSED_QB", 16)),
                device=dev,
            )
        else:
            from leann_tpu_torch.ops.beam import BeamSearchEngine

            self.engine = BeamSearchEngine(
                vectors=vectors,
                adjacency=graph.adjacency,
                medoid=graph.medoid,
                metric=metric,
                expansions=2,
                device=dev,
            )

    def __len__(self) -> int:
        return self.engine.n

    def search(
        self, queries: np.ndarray, k: int, complexity: int = 64
    ) -> Tuple[np.ndarray, np.ndarray]:
        """complexity = beam width."""
        return self.engine.search(queries, k=k, beam_width=max(complexity, k))


def load_searcher(base: str, meta, sharded: bool = False,
                  device: DeviceLike = None):
    if sharded:
        raise _not_ported("sharded search", "Queue A 12, sharding")
    return _load_local_searcher(base, meta, device)


def _load_local_searcher(base: str, meta, device: DeviceLike = None):
    from leann_tpu_torch.store.embeddings import EmbeddingsStore
    from leann_tpu_torch.store.graphfile import GraphFile, graph_path

    backend = resolve_backend(meta.backend_name)
    metric = getattr(meta, "metric", "ip")
    if backend == "ivf":
        raise _not_ported("the ivf backend", "Queue A 9, IVF family")
    vectors = np.asarray(EmbeddingsStore(base, meta.dimensions).all())
    if backend == "flat" or not GraphFile.exists(base):
        # a graph meta with no graph file degrades to exact search, as in
        # the reference
        return FlatSearcher(vectors, metric=metric, device=device)
    graph = GraphFile.load(graph_path(base))
    return GraphSearcher(vectors, graph, metric=metric, base=base,
                         device=device)
