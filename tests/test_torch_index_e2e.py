"""End-to-end tests of the port: build -> search through
`leann_tpu_torch.index` with the fake embedder on CPU, indexes built by
either package searched by the other, and the port's independence from
JAX and from `leann_tpu`.

Tolerances: a doc's own text comes back first; cross-package top-10
overlap >= 0.95 (different float summation orders and traversal engines
may route a query differently)."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from leann_tpu.embed import EmbeddingProvider
from leann_tpu.index import IndexSearcher as JaxIndexSearcher
from leann_tpu.index.builder import IndexBuilder as JaxIndexBuilder
from leann_tpu_torch.embed.fake import FakeEmbedding
from leann_tpu_torch.index import (
    IndexBuilder, IndexSearcher, MetadataFilter, SearchOptions,
)

# the suite runs in several worker processes that share the CPUs: one
# intra-op thread each keeps PyTorch's many small ops from oversubscribing
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 128


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    topics = ["graph search", "vector index", "int8 records", "beam merge",
              "robust prune", "bm25 hybrid", "metadata filter", "kernels"]
    return [f"passage {i} on {topics[i % 8]} with token{rng.integers(1e6)}"
            for i in range(n)]


def _build(builder_cls, base, texts, backend, **kw):
    vecs = FakeEmbedding(D).embed(texts)
    b = builder_cls(base, dim=D, backend=backend, metric="ip", **kw)
    for i, (t, v) in enumerate(zip(texts, vecs)):
        b.add(f"d{i}", t, v, {"topic": i % 8, "source": f"f{i}.py"})
    b.build(graph_degree=16, complexity=32)
    return vecs


@pytest.mark.parametrize("backend", ["hnsw", "flat"])
def test_build_then_search_own_text_first(tmp_path, backend):
    base = str(tmp_path / "idx" / "documents.leann")
    texts = _texts(300)
    _build(IndexBuilder, base, texts, backend, device="cpu")
    for suffix in (".meta.json", ".embeddings", ".ids.txt",
                   ".passages.jsonl", ".bm25.npz"):
        assert os.path.exists(base + suffix)
    assert os.path.exists(base + ".graph.npz") == (backend == "hnsw")
    s = IndexSearcher.load(base, device="cpu")
    q = FakeEmbedding(D).embed([texts[i] for i in (3, 77, 250)])
    res = s.search(q, SearchOptions(top_k=3))
    assert [r[0].id for r in res] == ["d3", "d77", "d250"]
    assert res[0][0].score > 0.99
    # filter and hybrid run through the same pipeline
    flt = MetadataFilter.parse("topic=5")
    res = s.search(q[:1], SearchOptions(top_k=5, filter=flt))[0]
    assert res and all(r.metadata["topic"] == 5 for r in res)
    # hybrid fusion: the same ranking as the reference's searcher
    from leann_tpu.index import SearchOptions as JaxOptions

    other = FakeEmbedding(D).embed(["graph search kernels"])
    hyb = s.search(other, SearchOptions(top_k=5, hybrid=True,
                                        query_text=texts[42]))[0]
    ref = JaxIndexSearcher.load(base).search(
        other, JaxOptions(top_k=5, hybrid=True, query_text=texts[42]))[0]
    assert len(hyb) == 5
    assert [r.id for r in hyb] == [r.id for r in ref]


def _overlap(a, b):
    ids_a = [[r.id for r in row] for row in a]
    ids_b = [[r.id for r in row] for row in b]
    return np.mean([len(set(x) & set(y)) / max(len(y), 1)
                    for x, y in zip(ids_a, ids_b)])


def test_cross_load_both_ways(tmp_path):
    """An index built by leann_tpu is searched by the port and the other
    way round: top-10 overlap >= 0.95 against the builder's own search."""
    texts = _texts(400, seed=1)
    q = FakeEmbedding(D).embed([texts[i] for i in range(0, 400, 13)])
    opts = SearchOptions(top_k=10)

    jbase = str(tmp_path / "jax" / "documents.leann")
    _build(JaxIndexBuilder, jbase, texts, "hnsw")
    tbase = str(tmp_path / "torch" / "documents.leann")
    _build(IndexBuilder, tbase, texts, "hnsw", device="cpu")

    from leann_tpu.index import SearchOptions as JaxOptions

    jopts = JaxOptions(top_k=10)
    j_on_j = JaxIndexSearcher.load(jbase).search(q, jopts)
    t_on_j = IndexSearcher.load(jbase, device="cpu").search(q, opts)
    t_on_t = IndexSearcher.load(tbase, device="cpu").search(q, opts)
    j_on_t = JaxIndexSearcher.load(tbase).search(q, jopts)
    assert _overlap(t_on_j, j_on_j) >= 0.95
    assert _overlap(j_on_t, t_on_t) >= 0.95
    assert [r[0].id for r in t_on_j] == [f"d{i}" for i in range(0, 400, 13)]
    assert [r[0].id for r in j_on_t] == [f"d{i}" for i in range(0, 400, 13)]


def test_port_imports_no_jax_and_no_reference(tmp_path):
    """A fresh interpreter: import the port, build and search on CPU;
    then sys.modules holds no jax* and no leann_tpu.*."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import leann_tpu_torch
        from leann_tpu_torch.embed.fake import FakeEmbedding
        from leann_tpu_torch.index import IndexBuilder, IndexSearcher
        from leann_tpu_torch.ops.fused_beam import FusedBeamEngine
        base = {str(tmp_path / "i" / "documents.leann")!r}
        texts = [f"doc {{i}}" for i in range(200)]
        vecs = FakeEmbedding(128).embed(texts)
        b = IndexBuilder(base, dim=128, backend="hnsw", device="cpu")
        for i, (t, v) in enumerate(zip(texts, vecs)):
            b.add(f"d{{i}}", t, v)
        b.build(graph_degree=8, complexity=16)
        res = IndexSearcher.load(base, device="cpu").search(vecs[:2])
        assert res[0][0].id == "d0", res[0][0].id
        FusedBeamEngine(vecs, np.zeros((200, 8), np.int32), 0,
                        device="cpu").search(vecs[:1], k=3)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m.startswith("jaxlib") or m == "leann_tpu"
                     or m.startswith("leann_tpu."))
        assert not bad, bad
        print("clean")
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout


def test_cuda_requested_without_cuda_raises(monkeypatch, tmp_path):
    from leann_tpu_torch import device as dv
    from leann_tpu_torch.ops.distance import ExactEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dv.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        dv.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ExactEngine(np.zeros((4, 8), np.float32))
    base = str(tmp_path / "i" / "documents.leann")
    with pytest.raises(RuntimeError, match="CUDA"):
        IndexBuilder(base, dim=D, backend="hnsw")
    assert dv.resolve_device("cpu").type == "cpu"


def test_unported_backends_raise(tmp_path):
    base = str(tmp_path / "i" / "documents.leann")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        IndexBuilder(base, dim=D, backend="ivf", device="cpu")
    _build(IndexBuilder, base, _texts(50), "flat", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        IndexSearcher.load(base, sharded=True, device="cpu")


def test_bm25_sidecar_matches_reference(tmp_path):
    from leann_tpu.index.bm25 import Bm25Scorer as JaxBm25
    from leann_tpu_torch.index.bm25 import Bm25Scorer

    texts = _texts(120, seed=3)
    mine = Bm25Scorer.build(texts)
    ref = JaxBm25._build_python(texts)
    path = str(tmp_path / "x.bm25.npz")
    mine.save(path)
    loaded = JaxBm25.load(path)
    for query in ("graph search", "bm25 hybrid token", "passage 7"):
        np.testing.assert_allclose(mine.score_query(query),
                                   ref.score_query(query), rtol=1e-6)
        np.testing.assert_allclose(loaded.score_query(query),
                                   ref.score_query(query), rtol=1e-6)


def test_fake_embedder_matches_reference():
    texts = _texts(10)
    np.testing.assert_array_equal(
        FakeEmbedding(D).embed(texts),
        EmbeddingProvider(mode="fake", dimensions=D).embed(texts))
