"""BM25 scoring for hybrid search.

Same scoring math and tokenization as the reference
(`src/index/bm25.rs:9-170`: k1=1.2, b=0.75, tokens = lowercased
[a-zA-Z0-9]+ of length > 1, idf = ln((N - df + 0.5)/(df + 0.5) + 1)),
but a different engine: the reference rebuilds dense per-doc hashmaps
from the whole corpus *per query* (`src/index/searcher.rs:149-151`) and
scores every document per term (`bm25.rs:90-102`). Here the stats are
built once at index time, persisted as packed numpy postings
(`<base>.bm25.npz`), and queries score only the documents in the
matching posting lists with vectorized numpy — O(matched postings), not
O(corpus x terms).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

K1 = 1.2
B = 0.75

_TOKEN_RE = re.compile(r"[a-zA-Z0-9]+")


def tokenize(text: str) -> List[str]:
    return [t for t in (m.group(0).lower() for m in _TOKEN_RE.finditer(text)) if len(t) > 1]


def bm25_path(base: str) -> str:
    return base + ".bm25.npz"


class Bm25Scorer:
    """Packed postings BM25 index.

    Arrays:
      vocab        [V]  unicode terms, sorted
      offsets      [V+1] int64 into the postings arrays
      post_docs    [P]  int32 doc ids
      post_tfs     [P]  int32 term frequencies
      doc_lengths  [N]  int32
    """

    def __init__(
        self,
        vocab: np.ndarray,
        offsets: np.ndarray,
        post_docs: np.ndarray,
        post_tfs: np.ndarray,
        doc_lengths: np.ndarray,
    ):
        self.vocab = vocab
        self.offsets = offsets
        self.post_docs = post_docs
        self.post_tfs = post_tfs
        self.doc_lengths = doc_lengths.astype(np.float32)
        self.num_docs = int(doc_lengths.shape[0])
        self.avg_doc_len = float(doc_lengths.mean()) if self.num_docs else 1.0
        # Precompute the length-normalization denominator factor.
        self._norm = 1.0 - B + B * (self.doc_lengths / max(self.avg_doc_len, 1e-9))

    # ---------------- construction ----------------

    @staticmethod
    def build(documents: Sequence[str]) -> "Bm25Scorer":
        return Bm25Scorer._build_python(documents)

    @staticmethod
    def _build_python(documents: Sequence[str]) -> "Bm25Scorer":
        term_postings: Dict[str, List[Tuple[int, int]]] = {}
        doc_lengths = np.zeros(len(documents), dtype=np.int32)
        for doc_id, doc in enumerate(documents):
            tokens = tokenize(doc)
            doc_lengths[doc_id] = len(tokens)
            tf: Dict[str, int] = {}
            for tok in tokens:
                tf[tok] = tf.get(tok, 0) + 1
            for tok, count in tf.items():
                term_postings.setdefault(tok, []).append((doc_id, count))

        vocab_list = sorted(term_postings)
        offsets = np.zeros(len(vocab_list) + 1, dtype=np.int64)
        docs_parts: List[np.ndarray] = []
        tfs_parts: List[np.ndarray] = []
        total = 0
        for i, term in enumerate(vocab_list):
            plist = term_postings[term]
            total += len(plist)
            offsets[i + 1] = total
            docs_parts.append(np.fromiter((d for d, _ in plist), dtype=np.int32))
            tfs_parts.append(np.fromiter((c for _, c in plist), dtype=np.int32))
        post_docs = (
            np.concatenate(docs_parts) if docs_parts else np.zeros(0, dtype=np.int32)
        )
        post_tfs = (
            np.concatenate(tfs_parts) if tfs_parts else np.zeros(0, dtype=np.int32)
        )
        vocab = np.asarray(vocab_list, dtype=np.str_)
        return Bm25Scorer(vocab, offsets, post_docs, post_tfs, doc_lengths)

    # ---------------- persistence ----------------

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            vocab=self.vocab,
            offsets=self.offsets,
            post_docs=self.post_docs,
            post_tfs=self.post_tfs,
            doc_lengths=self.doc_lengths.astype(np.int32),
        )

    @staticmethod
    def load(path: str) -> "Bm25Scorer":
        with np.load(path, allow_pickle=False) as z:
            return Bm25Scorer(
                vocab=z["vocab"],
                offsets=z["offsets"],
                post_docs=z["post_docs"],
                post_tfs=z["post_tfs"],
                doc_lengths=z["doc_lengths"],
            )

    # ---------------- scoring ----------------

    def _term_slice(self, term: str) -> Optional[Tuple[int, int]]:
        i = int(np.searchsorted(self.vocab, term))
        if i >= self.vocab.shape[0] or self.vocab[i] != term:
            return None
        return int(self.offsets[i]), int(self.offsets[i + 1])

    def score_query(self, query: str) -> np.ndarray:
        """Dense [N] score array (sparse internally)."""
        scores = np.zeros(self.num_docs, dtype=np.float32)
        for token in tokenize(query):
            span = self._term_slice(token)
            if span is None:
                continue
            lo, hi = span
            df = hi - lo
            idf = np.log((self.num_docs - df + 0.5) / (df + 0.5) + 1.0)
            docs = self.post_docs[lo:hi]
            tfs = self.post_tfs[lo:hi].astype(np.float32)
            norm = self._norm[docs]
            scores[docs] += idf * (tfs * (K1 + 1.0)) / (tfs + K1 * norm)
        return scores

    def search(self, query: str, top_k: int) -> List[Tuple[int, float]]:
        scores = self.score_query(query)
        nz = np.flatnonzero(scores > 0.0)
        if nz.size == 0:
            return []
        if nz.size > top_k:
            part = nz[np.argpartition(-scores[nz], top_k - 1)[:top_k]]
        else:
            part = nz
        order = part[np.argsort(-scores[part])]
        return [(int(i), float(scores[i])) for i in order]


def hybrid_rerank(
    vector_results: Sequence[Tuple[int, float]],
    bm25_scores: np.ndarray,
    alpha: float,
) -> List[Tuple[int, float]]:
    """Min-max normalize both score sets, blend alpha*vec + (1-alpha)*bm25,
    sort desc — same fusion as the reference (`src/index/bm25.rs:135-170`)."""
    if not vector_results:
        return []
    vec = np.asarray([s for _, s in vector_results], dtype=np.float32)
    idx = np.asarray([i for i, _ in vector_results], dtype=np.int64)
    vec_range = max(float(vec.max() - vec.min()), 1e-6)
    vec_norm = (vec - float(vec.min())) / vec_range
    bmax = float(bm25_scores.max()) if bm25_scores.size else 0.0
    bmin = float(bm25_scores.min()) if bm25_scores.size else 0.0
    b_range = max(bmax - bmin, 1e-6)
    bm = np.where(
        (idx >= 0) & (idx < bm25_scores.shape[0]), bm25_scores[np.clip(idx, 0, max(bm25_scores.shape[0] - 1, 0))], 0.0
    )
    bm_norm = (bm - bmin) / b_range
    combined = alpha * vec_norm + (1.0 - alpha) * bm_norm
    order = np.argsort(-combined, kind="stable")
    return [(int(idx[j]), float(combined[j])) for j in order]
