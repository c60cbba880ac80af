"""Index builders (port of `leann_tpu/index/builder.py`).

StreamingIndexBuilder streams passages/ids/embeddings to disk as chunks
are embedded and builds the ANN structure at the end, on `device`
(default cuda). It writes the same files as the reference: passages,
offsets, ids, raw-f32 embeddings, meta, the graph and the BM25 sidecar.
Builds resume from a `.ckpt.json` of consistent stream lengths.

This slice builds `flat` and `vamana` (`hnsw`, `diskann`). The `ivf`
backend and recompute-ready token sidecars raise until their slices land.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from leann_tpu_torch.store.embeddings import EmbeddingsWriter, embeddings_path
from leann_tpu_torch.store.graphfile import GraphFile, graph_path
from leann_tpu_torch.store.meta import IndexMeta, meta_path
from leann_tpu_torch.store.passages import (
    Passage,
    PassageStore,
    PassageStoreWriter,
    passages_path,
    read_ids,
    write_ids,
)
from leann_tpu_torch.index.bm25 import Bm25Scorer, bm25_path
from leann_tpu_torch.backend import resolve_backend


def ckpt_path(base: str) -> str:
    return base + ".ckpt.json"


class StreamingIndexBuilder:
    def __init__(
        self,
        base: str,
        dim: int,
        backend: str = "flat",
        metric: str = "ip",
        embedding_model: str = "fake",
        embedding_mode: str = "fake",
        embedding_options: Optional[Dict] = None,
        is_recompute: bool = False,
        build_bm25: bool = True,
        tokenizer_encoder=None,
        resume: bool = False,
        device=None,
    ):
        from leann_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.base = base
        self.dim = dim
        self.backend = resolve_backend(backend)
        self.metric = metric
        self.embedding_model = embedding_model
        self.embedding_mode = embedding_mode
        self.embedding_options = embedding_options
        self.is_recompute = is_recompute
        self.build_bm25 = build_bm25
        self.tokenizer_encoder = tokenizer_encoder
        self.files_done = 0
        if self.backend == "ivf":
            raise NotImplementedError(
                "the ivf backend is not ported to leann_tpu_torch yet "
                "(ROADMAP: Queue A 9, IVF family)")
        if is_recompute and tokenizer_encoder is not None:
            raise NotImplementedError(
                "recompute token sidecars are not ported to leann_tpu_torch "
                "yet (ROADMAP: Queue A 7-8, BERT and pruned recompute)")

        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
        if resume and os.path.exists(ckpt_path(base)):
            self._resume()
        else:
            self._passages = PassageStoreWriter(base)
            self._embeddings = EmbeddingsWriter(base, dim)
            self._ids: List[str] = []

    def _resume(self) -> None:
        """Truncate streams to the last consistent checkpoint, reopen in
        append mode."""
        with open(ckpt_path(self.base), "r", encoding="utf-8") as f:
            ckpt = json.load(f)
        if ckpt.get("dim") != self.dim:
            raise ValueError(
                f"checkpoint dim {ckpt.get('dim')} != current dim {self.dim}; "
                "rebuild with --force"
            )
        rows = int(ckpt["embeddings_rows"])
        with open(passages_path(self.base), "r+b") as f:
            f.truncate(int(ckpt["passages_bytes"]))
        with open(embeddings_path(self.base), "r+b") as f:
            f.truncate(rows * self.dim * 4)
        ids = read_ids(self.base)[:rows]
        write_ids(self.base, ids)
        # rebuild the offset map by scanning the (truncated) passage file
        offsets = {}
        pos = 0
        with open(passages_path(self.base), "rb") as f:
            for line in f:
                if line.strip():
                    pid = json.loads(line)["id"]
                    offsets[str(pid)] = pos
                pos += len(line)
        self._passages = PassageStoreWriter(self.base, append=True)
        self._passages._offsets = offsets
        self._embeddings = EmbeddingsWriter(self.base, self.dim, append=True)
        self._ids = ids
        self.files_done = int(ckpt.get("files_done", 0))

    def add_passage(self, passage: Passage, embedding: np.ndarray) -> None:
        self._passages.add(passage)
        self._embeddings.add(np.asarray(embedding, dtype=np.float32))
        self._ids.append(passage.id)

    def add_batch(self, passages: Sequence[Passage], embeddings: np.ndarray) -> None:
        for p, e in zip(passages, embeddings):
            self.add_passage(p, e)

    def __len__(self) -> int:
        return len(self._ids)

    def has_id(self, pid: str) -> bool:
        return pid in self._passages._offsets

    def checkpoint(self, files_done: int) -> None:
        """Flush all streams and record a consistent resume point."""
        self._passages._f.flush()
        self._embeddings._f.flush()
        write_ids(self.base, self._ids)
        self.files_done = files_done
        with open(ckpt_path(self.base), "w", encoding="utf-8") as f:
            json.dump({
                "dim": self.dim,
                "files_done": files_done,
                "passages_bytes": self._passages._pos,
                "embeddings_rows": self._embeddings.count,
            }, f)

    def build(
        self,
        graph_degree: int = 32,
        complexity: int = 64,
        alpha: float = 1.2,
    ) -> IndexMeta:
        from leann_tpu_torch.utils import span

        self._passages.finish()
        self._embeddings.finish()
        write_ids(self.base, self._ids)

        backend_kwargs = None
        if self.backend == "vamana":
            from leann_tpu_torch.ops.vamana import build_vamana
            from leann_tpu_torch.store.embeddings import EmbeddingsStore

            vectors = np.asarray(EmbeddingsStore(self.base, self.dim).all())
            with span("build.vamana", n=len(vectors)):
                adjacency, medoid = build_vamana(
                    vectors,
                    graph_degree=graph_degree,
                    complexity=complexity,
                    alpha=alpha,
                    metric=self.metric,
                    device=self.device,
                )
            GraphFile(adjacency, medoid, self.metric).save(graph_path(self.base))
            backend_kwargs = {
                "graph_degree": graph_degree,
                "complexity": complexity,
                "alpha": alpha,
            }

        texts: Optional[List[str]] = None
        if self.build_bm25:
            store = PassageStore(self.base)
            pos = {pid: i for i, pid in enumerate(self._ids)}
            texts = [""] * len(self._ids)
            for p in store.iter_all():
                i = pos.get(p.id)
                if i is not None:
                    texts[i] = p.text

        if self.build_bm25 and texts:
            with span("build.bm25", docs=len(texts)):
                Bm25Scorer.build(texts).save(bm25_path(self.base))

        meta = IndexMeta(
            backend_name=self.backend,
            embedding_model=self.embedding_model,
            embedding_mode=self.embedding_mode,
            dimensions=self.dim,
            passage_count=len(self._ids),
            backend_kwargs=backend_kwargs,
            embedding_options=self.embedding_options,
            is_recompute=self.is_recompute,
            is_pruned=False,
            metric=self.metric,
        )
        meta.save(meta_path(self.base))
        _invalidate_sidecars(self.base)
        if os.path.exists(ckpt_path(self.base)):
            os.remove(ckpt_path(self.base))
        return meta


def _invalidate_sidecars(base: str) -> None:
    """A rebuild at the same base invalidates sidecars derived from the
    previous corpus: the reference's shard and PQ files (the same names
    as `leann_tpu/store/{shardfile,pqfile}.py` write)."""
    for suffix in (".shards.npz", ".pq.npz"):
        if os.path.exists(base + suffix):
            os.remove(base + suffix)


class IndexBuilder:
    """In-memory convenience builder (reference `src/index/builder.rs:14-130`)."""

    def __init__(self, base: str, dim: int, **kwargs):
        self._streaming = StreamingIndexBuilder(base, dim, **kwargs)

    def add(self, pid: str, text: str, embedding: np.ndarray, metadata=None) -> None:
        self._streaming.add_passage(
            Passage(id=pid, text=text, metadata=metadata or {}), embedding
        )

    def build(self, **kwargs) -> IndexMeta:
        return self._streaming.build(**kwargs)
