"""On-disk index formats, byte-compatible with `leann_tpu`'s:

  <base>.passages.jsonl      one JSON passage per line
  <base>.passages.idx.json   {id: byte_offset} map
  <base>.ids.txt             newline-separated string ids (position = int id)
  <base>.embeddings          raw little-endian f32 row-major matrix
  <base>.meta.json           IndexMeta JSON
  <base>.graph.npz           packed fixed-degree adjacency
  <base>.bm25.npz            persisted BM25 postings
  <base>.pq.npz              PQ codebooks and codes (store/pqfile.py)
  <base>.ivf.npz             IVF k-means centers and assignment (store/ivffile.py)
  <base>.tokens.npz          token ids and lengths for pruned recompute (store/tokens.py)
  <base>.shards.npz          per-shard graphs or k-means (store/shardfile.py)
"""

from leann_tpu_torch.store.passages import Passage, PassageStore, PassageStoreWriter
from leann_tpu_torch.store.embeddings import EmbeddingsStore, EmbeddingsWriter
from leann_tpu_torch.store.meta import IndexMeta
from leann_tpu_torch.store.graphfile import GraphFile

__all__ = [
    "Passage",
    "PassageStore",
    "PassageStoreWriter",
    "EmbeddingsStore",
    "EmbeddingsWriter",
    "IndexMeta",
    "GraphFile",
]
