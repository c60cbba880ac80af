"""`update` — incremental add of new documents to an existing index
(port of `leann_tpu/cli/update_cmd.py`; reference
`src/cli/update.rs:58-242`). Improvement over the reference: it rejects
DiskANN updates (update.rs:72-75); the vamana engine supports
incremental insertion waves, so every backend is updatable. The graph's
insertion waves, the IVF assignment and its retraining run on
`args.device`."""

from __future__ import annotations

import os
import sys

import numpy as np

from leann_tpu_torch.chunker import ChunkingStrategy, SmartChunker
from leann_tpu_torch.cli.common import (
    collect_file_paths,
    load_file_content,
    provider_from_meta,
    resolve_build_template,
)
from leann_tpu_torch.cli.main import primary_device
from leann_tpu_torch.config import Config
from leann_tpu_torch.index.bm25 import Bm25Scorer, bm25_path
from leann_tpu_torch.store.embeddings import EmbeddingsStore, EmbeddingsWriter
from leann_tpu_torch.store.graphfile import GraphFile, graph_path
from leann_tpu_torch.store.locate import find_index, index_base
from leann_tpu_torch.store.meta import IndexMeta, meta_path
from leann_tpu_torch.store.passages import (
    Passage,
    PassageStore,
    PassageStoreWriter,
    read_ids,
    write_ids,
)


def add_parser(sub):
    p = sub.add_parser("update", help="Update an existing index with new documents")
    p.add_argument("index_name")
    p.add_argument("--docs", nargs="+", required=True)
    p.add_argument("--file-types", default=None)
    p.add_argument("--exclude-types", default=None)
    p.add_argument("--include-hidden", action="store_true")
    p.add_argument("--max-files", type=int, default=None)
    p.add_argument("--doc-chunk-size", type=int, default=None)
    p.add_argument("--doc-chunk-overlap", type=int, default=None)
    p.add_argument("--chunking-strategy", default="simple",
                   choices=["simple", "ast", "auto"])
    p.add_argument("--embedding-api-key", default=os.environ.get("OPENAI_API_KEY"))
    p.set_defaults(func=run)


def run(args) -> int:
    cfg = Config.load()
    try:
        index_dir = find_index(args.index_name)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 1
    base = index_base(index_dir)
    meta = IndexMeta.load(meta_path(base))
    if meta.is_pruned:
        print("Cannot update a pruned index (embeddings were deleted). "
              "Rebuild with --force instead.", file=sys.stderr)
        return 1

    device = primary_device(args.device)
    provider = provider_from_meta(meta, api_key=args.embedding_api_key,
                                  device=device)
    doc_template = resolve_build_template(meta, provider)

    files = collect_file_paths(
        args.docs,
        [s.strip() for s in args.file_types.split(",")] if args.file_types else cfg.build.file_types,
        [s.strip() for s in args.exclude_types.split(",")] if args.exclude_types else cfg.build.exclude_types,
        args.include_hidden,
        args.max_files,
        cfg.build.max_file_size_kb,
    )
    if not files:
        print("No files found to add.", file=sys.stderr)
        return 1

    chunker = SmartChunker(
        args.doc_chunk_size or cfg.build.chunk_size,
        args.doc_chunk_overlap
        if args.doc_chunk_overlap is not None
        else cfg.build.chunk_overlap,
        ChunkingStrategy.parse(args.chunking_strategy),
    )

    existing = PassageStore(base)
    ids = read_ids(base)
    new_passages = []
    for path in files:
        content = load_file_content(path)
        if content is None:
            continue
        for c in chunker.chunk(content, path):
            if c.id in existing.offsets:
                continue  # already indexed
            new_passages.append(Passage(id=c.id, text=c.text, metadata=c.metadata))
    if not new_passages:
        print("No new chunks to add.")
        return 0

    print(f"Embedding {len(new_passages)} new chunks...")
    vecs = []
    batch = 100
    for i in range(0, len(new_passages), batch):
        vecs.append(
            provider.embed_with_template(
                [p.text for p in new_passages[i : i + batch]], doc_template
            )
        )
    new_vecs = np.concatenate(vecs, axis=0)

    # append passages + embeddings, rewrite ids
    with PassageStoreWriter(base, append=True) as w:
        for p in new_passages:
            w.add(p)
    with EmbeddingsWriter(base, meta.dimensions, append=True) as ew:
        ew.add(new_vecs)
    old_n = len(ids)
    ids.extend(p.id for p in new_passages)
    write_ids(base, ids)

    # extend the graph incrementally
    if meta.backend_name == "vamana" and GraphFile.exists(base):
        from leann_tpu_torch.ops.vamana import insert_points

        graph = GraphFile.load(graph_path(base))
        all_vecs = np.asarray(EmbeddingsStore(base, meta.dimensions).all())
        n_total = all_vecs.shape[0]
        r = graph.degree
        # The stored sentinel is old_n ("one past last"); after growth it
        # would alias the first new node and every stale pad would become
        # a real edge. Remap stale sentinels to the new sentinel, and seed
        # the new rows with the sentinel too (insert_points replaces them).
        old_adj = np.where(graph.adjacency == old_n, n_total, graph.adjacency)
        new_rows = np.full((n_total - old_n, r), n_total, dtype=np.int32)
        adjacency = np.concatenate([old_adj, new_rows])
        # old rows now have capacity to point at new ids; re-run insertion
        kwargs = meta.backend_kwargs or {}
        adjacency = insert_points(
            all_vecs, adjacency, graph.medoid,
            np.arange(old_n, n_total),
            graph_degree=r,
            complexity=kwargs.get("complexity", 64),
            alpha=kwargs.get("alpha", 1.2),
            metric=meta.metric,
            device=device,
        )
        GraphFile(adjacency, graph.medoid, graph.metric).save(graph_path(base))

    # extend the IVF index incrementally: new vectors join their nearest
    # existing centroid; once enough of the corpus post-dates the trained
    # centroids (>25% drift), retrain them so bucket balance doesn't
    # silently degrade over repeated updates
    from leann_tpu_torch.store.ivffile import IvfFile, ivf_path

    if meta.backend_name == "ivf" and IvfFile.exists(base):
        from leann_tpu_torch.ops.distance import exact_topk

        ivf = IvfFile.load(ivf_path(base))
        metric = "ip" if meta.metric == "cosine" else meta.metric
        n_total_ivf = len(ivf.assign) + len(new_vecs)
        drift = (n_total_ivf - ivf.trained_n) / max(1, n_total_ivf)
        if drift > 0.25:
            from leann_tpu_torch.ops.ivf import kmeans

            print(f"IVF centroid drift {drift:.0%} > 25%: retraining "
                  f"{len(ivf.centers)} centroids...")
            av = np.asarray(EmbeddingsStore(base, meta.dimensions).all())
            if meta.metric == "cosine":
                av = av / (np.linalg.norm(av, axis=1, keepdims=True) + 1e-12)
            centers, assign = kmeans(
                av, len(ivf.centers), metric=metric, seed=0, device=device
            )
            IvfFile(centers, assign, ivf.metric,
                    trained_n=n_total_ivf).save(ivf_path(base))
            # new centroids invalidate the old nprobe operating point
            if os.environ.get("LEANN_IVF_CALIBRATE", "1") != "0" \
                    and len(av) >= 1000:
                from leann_tpu_torch.ops.ivf import IvfEngine

                eng = IvfEngine(av, metric=meta.metric,
                                centers=centers, assign=assign,
                                device=device)
                nprobe, rec = eng.calibrate_nprobe()
                meta.backend_kwargs = dict(meta.backend_kwargs or {})
                meta.backend_kwargs["nprobe"] = int(nprobe)
                meta.backend_kwargs["calibrated_recall10"] = round(rec, 4)
                del eng
        else:
            nv = new_vecs
            if meta.metric == "cosine":
                nv = nv / (np.linalg.norm(nv, axis=1, keepdims=True) + 1e-12)
            _, nearest = exact_topk(nv, ivf.centers, 1, metric=metric,
                                    device=device)
            new_assign = nearest[:, 0].astype(np.int32)
            IvfFile(
                ivf.centers,
                np.concatenate([ivf.assign, new_assign]),
                ivf.metric,
                trained_n=ivf.trained_n,
            ).save(ivf_path(base))

    # refresh the BM25 sidecar
    if os.path.exists(bm25_path(base)):
        store = PassageStore(base)
        pos = {pid: i for i, pid in enumerate(ids)}
        texts = [""] * len(ids)
        for p in store.iter_all():
            i = pos.get(p.id)
            if i is not None:
                texts[i] = p.text
        Bm25Scorer.build(texts).save(bm25_path(base))

    meta.passage_count = len(ids)
    meta.save(meta_path(base))
    print(f"Added {len(new_passages)} chunks "
          f"({old_n} -> {len(ids)} passages).")
    return 0
