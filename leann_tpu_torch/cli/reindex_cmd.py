"""`reindex` — rebuild the ANN structure from stored embeddings without
re-embedding anything (port of `leann_tpu/cli/reindex_cmd.py`).

Uses: switch backends (flat <-> ivf <-> vamana), rebuild after many
updates, or migrate an index written by Python LEANN / leann-rs — their
passages/ids/embeddings/meta files are byte-compatible; only the native
ANN binary is foreign, and this command replaces it with the engine's
own artifacts (`graph.npz`, `ivf.npz`, which both packages read). The
graph build, k-means and the nprobe calibration run on `args.device`.
(The reference can only `build --force`, which re-embeds the whole
corpus.)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from leann_tpu_torch.backend import resolve_backend
from leann_tpu_torch.cli.main import primary_device
from leann_tpu_torch.index.bm25 import Bm25Scorer, bm25_path
from leann_tpu_torch.store.embeddings import EmbeddingsStore
from leann_tpu_torch.store.graphfile import GraphFile, graph_path
from leann_tpu_torch.store.ivffile import IvfFile, ivf_path
from leann_tpu_torch.store.locate import find_index, index_base
from leann_tpu_torch.store.meta import IndexMeta, meta_path
from leann_tpu_torch.store.passages import PassageStore, read_ids


def add_parser(sub):
    p = sub.add_parser(
        "reindex",
        help="Rebuild the ANN structure from stored embeddings "
             "(switch backends / migrate foreign indexes) without re-embedding",
    )
    p.add_argument("index_name")
    p.add_argument("--backend-name", default=None,
                   choices=["hnsw", "diskann", "flat", "vamana", "ivf"],
                   help="Target backend (default: keep current)")
    p.add_argument("--metric", default=None, choices=["ip", "l2", "cosine"])
    p.add_argument("--graph-degree", type=int, default=32)
    p.add_argument("--complexity", type=int, default=64)
    p.add_argument("--alpha", type=float, default=1.2)
    p.add_argument("--rebuild-bm25", action="store_true",
                   help="Also rebuild the BM25 sidecar from passages")
    p.add_argument("--keep-graph", action="store_true",
                   help="When migrating a usearch .index: serve its "
                        "level-0 HNSW adjacency directly as the "
                        "graph instead of rebuilding (instant migration)")
    p.set_defaults(func=run)


def _recover_from_usearch(base: str, meta: IndexMeta) -> bool:
    """Pruned index + foreign usearch `.index` binary: recover the
    embedding matrix from the binary itself (usearch's default
    serialization embeds the raw f32 vectors — leann-rs's
    `src/backend/hnsw.rs:133-135` saves with defaults)
    and write it back to the `.embeddings` store so the normal reindex
    path proceeds. Returns True on success."""
    from leann_tpu_torch.backend.usearch_import import (
        UsearchParseError, looks_like_usearch, parse_usearch_index,
        to_key_order)
    from leann_tpu_torch.store.embeddings import embeddings_path

    path = base + ".index"
    if not os.path.exists(path) or not looks_like_usearch(path):
        return False
    try:
        data = parse_usearch_index(path)
        vectors, _, _ = to_key_order(data)
    except UsearchParseError as e:
        print(f"usearch import failed ({e}); falling back.",
              file=sys.stderr)
        return False
    if vectors is None:
        print("usearch index was saved without vectors; cannot recover "
              "embeddings from it.", file=sys.stderr)
        return False
    if meta.dimensions and vectors.shape[1] != meta.dimensions:
        print(f"usearch index is {vectors.shape[1]}-d but meta says "
              f"{meta.dimensions}-d; not importing.", file=sys.stderr)
        return False
    print(f"Recovered {vectors.shape[0]} x {vectors.shape[1]} f32 "
          f"embeddings from the usearch binary at {path}")
    np.ascontiguousarray(vectors, dtype="<f4").tofile(
        embeddings_path(base))
    meta.is_pruned = False
    meta.save(meta_path(base))
    return True


def _import_usearch_graph(base: str, n_ids: int):
    """Parse the foreign usearch binary's level-0 HNSW adjacency into
    the graph file's format (key order, pad = n). Returns (adjacency,
    medoid) or None. The level-0 layer of a usearch HNSW is a
    navigable-small-world graph over every node — directly traversable
    by the frontier-batched beam (upper layers only accelerate entry
    selection, which the seed pool replaces)."""
    from leann_tpu_torch.backend.usearch_import import (
        UsearchParseError, looks_like_usearch, parse_usearch_index,
        to_key_order)

    path = base + ".index"
    if not os.path.exists(path) or not looks_like_usearch(path):
        return None
    try:
        data = parse_usearch_index(path)
        _, adjacency, medoid = to_key_order(data)
    except UsearchParseError as e:
        print(f"usearch graph import failed ({e})", file=sys.stderr)
        return None
    if adjacency.shape[0] != n_ids:
        print(f"usearch graph has {adjacency.shape[0]} nodes but ids.txt "
              f"has {n_ids}; not importing.", file=sys.stderr)
        return None
    return adjacency, int(medoid)


def run(args) -> int:
    try:
        index_dir = find_index(args.index_name)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 1
    base = index_base(index_dir)
    meta = IndexMeta.load(meta_path(base))
    device = primary_device(args.device)
    if meta.is_pruned or not EmbeddingsStore.exists(base):
        if not _recover_from_usearch(base, meta):
            print("No stored embeddings (index is pruned); reindex "
                  "requires them. Rebuild with `build --force` instead.",
                  file=sys.stderr)
            return 1

    backend = resolve_backend(args.backend_name or meta.backend_name)
    metric = args.metric or getattr(meta, "metric", "ip")
    vectors = np.asarray(EmbeddingsStore(base, meta.dimensions).all())
    ids = read_ids(base)
    if len(ids) != vectors.shape[0]:
        print(f"ids.txt has {len(ids)} entries but embeddings hold "
              f"{vectors.shape[0]} rows — index is inconsistent.",
              file=sys.stderr)
        return 1

    print(f"Reindexing '{args.index_name}': {vectors.shape[0]} vectors "
          f"-> backend={backend}, metric={metric}")
    t0 = time.time()
    backend_kwargs = None
    if backend == "vamana" and getattr(args, "keep_graph", False):
        imported = _import_usearch_graph(base, len(ids))
        if imported is None:
            print("--keep-graph: no parsable usearch .index found; "
                  "rebuilding instead.", file=sys.stderr)
        else:
            adjacency, medoid = imported
            GraphFile(adjacency, medoid, metric).save(graph_path(base))
            backend_kwargs = {
                "graph_degree": int(adjacency.shape[1]),
                "imported": "usearch-l0",
            }
            print(f"kept usearch level-0 graph: degree "
                  f"{adjacency.shape[1]}, entry {medoid} (no rebuild)")
    if backend == "vamana" and backend_kwargs is None:
        from leann_tpu_torch.ops.vamana import build_vamana

        adjacency, medoid = build_vamana(
            vectors, graph_degree=args.graph_degree,
            complexity=args.complexity, alpha=args.alpha, metric=metric,
            device=device,
        )
        GraphFile(adjacency, medoid, metric).save(graph_path(base))
        backend_kwargs = {
            "graph_degree": args.graph_degree,
            "complexity": args.complexity,
            "alpha": args.alpha,
        }
    elif backend == "ivf":
        from leann_tpu_torch.ops.ivf import kmeans

        m = "ip" if metric == "cosine" else metric
        v = vectors
        if metric == "cosine":
            v = v / (np.linalg.norm(v, axis=1, keepdims=True) + 1e-12)
        n_clusters = max(16, min(int(2 * len(v) ** 0.5), len(v)))
        centers, assign = kmeans(v, n_clusters, metric=m, device=device)
        IvfFile(centers, assign, metric).save(ivf_path(base))
        backend_kwargs = {"n_clusters": n_clusters}
        if os.environ.get("LEANN_IVF_CALIBRATE", "1") != "0" \
                and len(v) >= 1000:
            from leann_tpu_torch.ops.ivf import IvfEngine

            eng = IvfEngine(vectors, metric=metric,
                            centers=centers, assign=assign, device=device)
            nprobe, rec = eng.calibrate_nprobe()
            backend_kwargs["nprobe"] = int(nprobe)
            backend_kwargs["calibrated_recall10"] = round(rec, 4)
            print(f"calibrated nprobe={nprobe} (recall@10 {rec:.3f} on "
                  "self-queries)")
            del eng

    if args.rebuild_bm25:
        store = PassageStore(base)
        pos = {pid: i for i, pid in enumerate(ids)}
        texts = [""] * len(ids)
        for p in store.iter_all():
            i = pos.get(p.id)
            if i is not None:
                texts[i] = p.text
        Bm25Scorer.build(texts).save(bm25_path(base))

    meta.backend_name = backend
    meta.metric = metric
    meta.backend_kwargs = backend_kwargs
    meta.save(meta_path(base))
    print(f"Reindexed in {time.time() - t0:.1f}s.")
    return 0
