"""ANN backends (port of `leann_tpu/backend/__init__.py`).

  flat    exact matmul + top-k (the recall oracle)
  vamana  fixed-degree graph + beam search (aliases "hnsw" and "diskann"),
          served by the fused int8 engine, the PQ engine or the plain
          inline engine
  ivf     k-means buckets + bf16 scan + f32 rescore (`ops/ivf.py`), or
          ADC-compressed buckets (`ops/ivf_pq.py`) for corpora too large
          for that

A searcher takes a *batch* of query vectors. Every searcher runs on
`device` (default cuda; see `leann_tpu_torch.device`); `ShardedSearcher`
runs on a mesh of devices (`parallel/`).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

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
    within 9/16 of the free device memory, the fused CUDA traversal
    serves. When the int8 blocks do not fit or D % 128 != 0 (the DEEP
    shape: 96-d), the PQ engine serves if its records and the bf16
    rescore corpus fit 13/16 of the free memory: inline 8-bit ADC codes
    navigate, the beam and visited log are rescored exactly. The shares
    are the reference's, which states them in bytes of its own device.
    Otherwise (and always
    on CPU under "auto") the plain inline / row-gather engine serves;
    "pq" on CPU runs the PQ engine through the kernel's plain version."""

    def __init__(self, vectors: np.ndarray, graph, metric: str = "ip",
                 base: str = "", device: DeviceLike = None):
        self.metric = metric
        dev = resolve_device(device)
        vectors = np.asarray(vectors)
        n, d = vectors.shape
        r = graph.adjacency.shape[1]
        choice = os.environ.get("LEANN_GRAPH_ENGINE", "auto")
        use_fused = use_pq = False
        if choice == "auto":
            if kernels_available(dev) and r <= 128:
                free = free_device_bytes(dev)
                use_fused = d % 128 == 0 and (n + 1) * r * d < free * (9 / 16)
                m = next((mm for mm in (16, 12, 8) if d % mm == 0), 0)
                if not use_fused and m and r % 4 == 0:
                    from leann_tpu_torch.ops.pq_beam import pq_layout

                    cp = pq_layout(r, m, 8)[3]
                    use_pq = ((n + 1) * cp * 512 + n * d * 2
                              < free * (13 / 16))
        else:
            use_fused = choice == "fused"
            use_pq = choice == "pq"
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
        elif use_pq:
            self.engine = _pq_engine(vectors, graph, metric, base, dev)
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


class IvfSearcher:
    """Partitioned matmul search (`ops/ivf.py`).

    Engine selection (override with LEANN_IVF_ENGINE=pq): when the bf16
    tables and the f32 rescore corpus (6 bytes per element) pass 11/16 of
    the free device memory, ADC-compressed buckets (`IvfPqEngine`) serve
    instead, with the most precise rescore corpus that fits beside the
    codes: f32 within 4/16 of the free memory, bf16 within 8/16, else
    int8. The shares are the reference's, which states them in bytes of
    its own device (11e9, 4e9, 8e9); on the CPU, where "auto" never picks
    the PQ engine, the knob keeps the reference's byte constants so that
    both packages choose the same rescore."""

    def __init__(self, vectors: np.ndarray, ivf, metric: str = "ip",
                 default_nprobe: Optional[int] = None,
                 device: DeviceLike = None):
        self.metric = metric
        # build-time calibrated floor (meta.backend_kwargs["nprobe"]): a
        # calibrated corpus keeps its measured >= 0.95 operating point
        # even when callers pass the default complexity
        self.default_nprobe = default_nprobe
        dev = resolve_device(device)
        n, d = vectors.shape
        choice = os.environ.get("LEANN_IVF_ENGINE", "auto")
        m = next((mm for mm in (16, 12, 8) if d % mm == 0), 0)
        use_pq = choice == "pq" or (
            choice == "auto" and m and kernels_available(dev)
            and n * d * 6 > free_device_bytes(dev) * (11 / 16))
        if use_pq:
            from leann_tpu_torch.ops.ivf_pq import IvfPqEngine

            if dev.type == "cuda":
                free = free_device_bytes(dev)
                f32_max, bf16_max = free * (4 / 16), free * (8 / 16)
            else:
                f32_max, bf16_max = 4e9, 8e9
            rescore = ("f32" if n * d * 4 < f32_max
                       else "bf16" if n * d * 2 < bf16_max else "int8")
            self.engine = IvfPqEngine(
                vectors, metric=metric, m=m, rescore=rescore,
                centers=ivf.centers, assign=ivf.assign, device=dev)
        else:
            from leann_tpu_torch.ops.ivf import IvfEngine

            self.engine = IvfEngine(vectors, metric=metric,
                                    centers=ivf.centers, assign=ivf.assign,
                                    device=dev)

    def __len__(self) -> int:
        return self.engine.n

    def search(
        self, queries: np.ndarray, k: int, complexity: int = 64
    ) -> Tuple[np.ndarray, np.ndarray]:
        """complexity maps to nprobe (clusters probed per query)."""
        nprobe = max(complexity // 2, self.default_nprobe or 8)
        return self.engine.search(queries, k=k, nprobe=nprobe)


def _pq_engine(vectors, graph, metric, base, dev):
    """PqBeamEngine with m = the first of 16, 12, 8 that divides D and
    ksub = 256, its codebooks and codes loaded from the `.pq.npz` sidecar
    at `base` when present and saved there when trained.
    LEANN_PQ_OPQ=1 learns an OPQ rotation first; LEANN_PQ_RESCORE picks
    the rescore corpus (bf16 by default, int8 when memory is short)."""
    from leann_tpu_torch.ops.pq import train_opq
    from leann_tpu_torch.ops.pq_beam import PqBeamEngine
    from leann_tpu_torch.store import pqfile

    n, d = vectors.shape
    m = next((mm for mm in (16, 12, 8) if d % mm == 0), 8)
    want_opq = os.environ.get("LEANN_PQ_OPQ", "0") == "1"
    books = codes = rot = art = None
    if base:
        art = pqfile.load_pq(base, n, metric, want_rot=want_opq)
        if art is not None:
            books, codes, rot = art
    if want_opq and rot is None:
        rng = np.random.default_rng(0)
        samp = vectors[rng.choice(n, min(262_144, n), replace=False)]
        rot, books = train_opq(samp, m=m, ksub=256, device=dev)
        codes = None
    engine = PqBeamEngine(
        vectors=vectors,
        adjacency=graph.adjacency,
        medoid=graph.medoid,
        metric=metric,
        m=m,
        ksub=256,
        rescore=os.environ.get("LEANN_PQ_RESCORE", "bf16"),
        qb=int(os.environ.get("LEANN_FUSED_QB", 16)),
        codebooks=books,
        codes=codes,
        rotation=rot,
        device=dev,
    )
    if base and art is None:
        pqfile.save_pq(base, engine.codebooks, engine.codes, n, metric,
                       rot=engine.rotation)
    return engine


class ShardedSearcher:
    """Corpus row-sharded search over a mesh of devices
    (`parallel/sharded.py`) behind the backend-searcher interface.
    Dispatches on the index's backend: flat -> ShardedFlatIndex, vamana
    -> ShardedGraphIndex (one subgraph per shard), ivf ->
    ShardedIvfIndex (per-shard k-means).

    `devices` lists the mesh's devices, all on the shard axis (default:
    every CUDA device; a device may repeat, e.g. `["cpu"] * 8`).
    Per-shard graph/IVF structures are expensive to build, so they
    persist to `<base>.shards.npz` (`store/shardfile.py`, the reference's
    format): the first sharded load builds and saves; later loads with
    the same shard count reuse it."""

    def __init__(self, vectors: np.ndarray, metric: str = "ip",
                 backend: str = "flat", base: str = "", devices=None):
        from leann_tpu_torch.parallel import (
            ShardedFlatIndex, ShardedGraphIndex, ShardedIvfIndex,
            init_distributed, make_mesh,
        )
        from leann_tpu_torch.store import shardfile

        # the multi-process contract (a no-op in one process) comes
        # before the mesh, which counts the processes' shards
        init_distributed()
        mesh = make_mesh(devices=devices)
        self.n_shards = mesh.shape["shard"]
        self.backend = resolve_backend(backend)
        vectors = np.asarray(vectors)
        art = (
            shardfile.load_shards(
                base, self.n_shards, n=len(vectors), metric=metric
            )
            if base else None
        )
        save = bool(base) and mesh.process_index == 0

        if self.backend == "vamana":
            if art is not None and art["kind"] == "graph":
                self.index = ShardedGraphIndex(
                    vectors, mesh, metric=metric,
                    adjacency_shards=art["adjacency"],
                    medoids=art["medoids"],
                )
            else:
                self.index = ShardedGraphIndex(vectors, mesh, metric=metric)
                if save:
                    shardfile.save_graph_shards(
                        base, self.index.adjacency_shards,
                        self.index.medoids_host, self.index.n, metric,
                    )
        elif self.backend == "ivf":
            if art is not None and art["kind"] == "ivf":
                self.index = ShardedIvfIndex(
                    vectors, mesh, metric=metric,
                    centers_shards=art["centers_list"],
                    assign_shards=art["assign_list"],
                )
            else:
                self.index = ShardedIvfIndex(vectors, mesh, metric=metric)
                if save:
                    shardfile.save_ivf_shards(
                        base, self.index.centers_host,
                        self.index.assign_host, self.index.n, metric,
                    )
        else:
            self.index = ShardedFlatIndex(vectors, mesh, metric=metric)

    def __len__(self) -> int:
        return self.index.n

    def search(
        self, queries: np.ndarray, k: int, complexity: int = 64
    ) -> Tuple[np.ndarray, np.ndarray]:
        if self.backend == "vamana":
            return self.index.search(
                queries, k=k, beam_width=max(complexity, k)
            )
        if self.backend == "ivf":
            return self.index.search(
                queries, k=k, nprobe=max(complexity // 2, 8)
            )
        return self.index.search(queries, k=k)


def load_searcher(base: str, meta, sharded: bool = False,
                  device=None):
    """The searcher of the index at `base`. `device` is one device; for a
    sharded searcher it may also list the mesh's devices (one shard
    each; default: every CUDA device)."""
    if sharded:
        from leann_tpu_torch.store.embeddings import EmbeddingsStore

        devices = (list(device) if isinstance(device, (list, tuple))
                   else None if device is None else [device])
        vectors = EmbeddingsStore(base, meta.dimensions).all()
        return ShardedSearcher(
            np.asarray(vectors), metric=getattr(meta, "metric", "ip"),
            backend=meta.backend_name, base=base, devices=devices,
        )
    return _load_local_searcher(base, meta, device)


def _load_local_searcher(base: str, meta, device: DeviceLike = None):
    from leann_tpu_torch.store.embeddings import EmbeddingsStore
    from leann_tpu_torch.store.graphfile import GraphFile, graph_path
    from leann_tpu_torch.store.ivffile import IvfFile, ivf_path

    backend = resolve_backend(meta.backend_name)
    metric = getattr(meta, "metric", "ip")
    vectors = np.asarray(EmbeddingsStore(base, meta.dimensions).all())
    if backend == "ivf":
        ivf = IvfFile.load(ivf_path(base))
        kw = getattr(meta, "backend_kwargs", None) or {}
        return IvfSearcher(vectors, ivf, metric=metric,
                           default_nprobe=kw.get("nprobe"), device=device)
    if backend == "flat":
        return FlatSearcher(vectors, metric=metric, device=device)
    if not GraphFile.exists(base):
        # a hnsw/diskann meta with no graph file: probably an index built
        # by Python LEANN or leann-rs, which the reference diagnoses
        from leann_tpu_torch.backend.compat import sniff_foreign_index

        diagnosis = sniff_foreign_index(
            os.path.dirname(base), os.path.basename(base))
        if diagnosis:
            raise RuntimeError(diagnosis)
        # no graph at all: degrade to exact search, as the reference does
        return FlatSearcher(vectors, metric=metric, device=device)
    graph = GraphFile.load(graph_path(base))
    return GraphSearcher(vectors, graph, metric=metric, base=base,
                         device=device)
