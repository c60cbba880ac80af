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
        from leann_tpu_torch.ops.pq_beam import PqBeamEngine
        from leann_tpu_torch.ops.bucket_kernels import (
            ivf8_bucket_scores, ivf_bucket_dots)
        from leann_tpu_torch.ops.ivf import IvfEngine
        from leann_tpu_torch.ops.ivf_int8 import IvfInt8Engine
        from leann_tpu_torch.store import ivffile, pqfile
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
        pq = PqBeamEngine(vecs, np.zeros((200, 8), np.int32), 0, m=8,
                          ksub=16, kmeans_iters=2, device="cpu")
        pq.search(vecs[:1], k=3)
        pqfile.save_pq(base, pq.codebooks, pq.codes, 200, "ip")
        ivf = IvfEngine(vecs, n_clusters=8, device="cpu")
        ivf.search_pallas(vecs[:2], k=3)
        ivffile.IvfFile(ivf.centers, ivf.assign).save(base + ".ivf.npz")
        ivf8 = IvfInt8Engine(vecs, n_clusters=8, device="cpu")
        ivf8.search(vecs[:2], k=3)
        import os
        os.environ["LEANN_IVF8_PALLAS"] = "1"
        ivf8.search(vecs[:2], k=3)
        b = IndexBuilder(base + "2", dim=128, backend="ivf", device="cpu")
        for i, (t, v) in enumerate(zip(texts, vecs)):
            b.add(f"d{{i}}", t, v)
        b.build()
        res = IndexSearcher.load(base + "2", device="cpu").search(vecs[:2])
        assert res[0][0].id == "d0", res[0][0].id
        import torch
        from leann_tpu_torch.embed import LocalEmbedding
        from leann_tpu_torch.entry import entry
        from leann_tpu_torch.evals import gather_roofline
        from leann_tpu_torch.models import bert, fixture
        from leann_tpu_torch.ops.gather_score import gather_score
        from leann_tpu_torch.ops.ivf_pq import IvfPqEngine
        gather_score(torch.zeros((4, 8), dtype=torch.int8),
                     torch.zeros((2, 3), dtype=torch.int32),
                     torch.zeros((2, 8)))
        gather_roofline.run(n=64, b=2, r=2, m_scan=1, reps=1, d=16,
                            device="cpu")
        IvfPqEngine(vecs, n_clusters=8, m=8, ksub=16, device="cpu").search(
            vecs[:2], k=3, nprobe=4)
        os.environ["LEANN_IVF_ENGINE"] = "pq"
        res = IndexSearcher.load(base + "2", device="cpu").search(vecs[:2])
        assert res[0][0].id == "d0", res[0][0].id
        assert LocalEmbedding(device="cpu").embed(["a b"]).shape == (1, 64)
        fixture.write_bert_fixture(base + ".ckpt")
        bert.load_hf_params(base + ".ckpt", bert.BertConfig.from_hf_config(
            base + ".ckpt/config.json"))
        fn, args = entry(device="cpu")
        assert fn(*args)[0].shape == (16, 10)
        from leann_tpu_torch.index import (
            GraphRecomputeSearcher, RecomputeSearcher)
        from leann_tpu_torch.ops.beam import (
            RecomputeBeamEngine, beam_search_recompute_batch,
            beam_search_recompute_segmented)
        from leann_tpu_torch.store import tokens
        from leann_tpu_torch.store.embeddings import prune_embeddings
        enc = bert.BertEncoder(device="cpu")
        tok, mask = enc.tokenize_corpus(texts, max_length=8)
        tokens.save_tokens(base, tok, mask)
        eng = RecomputeBeamEngine(*tokens.load_tokens(base),
                                  np.zeros((200, 8), np.int32), 0, enc,
                                  device="cpu")
        assert eng.search(enc.embed(texts[:1]), k=3)[0].shape == (1, 3)
        from leann_tpu_torch.backend import ShardedSearcher
        from leann_tpu_torch.backend.compat import sniff_foreign_index
        from leann_tpu_torch.parallel import (
            ShardedFlatIndex, ShardedGraphIndex, ShardedIvf8Index,
            ShardedIvfIndex, init_distributed, make_mesh)
        from leann_tpu_torch.store import shardfile
        assert init_distributed() is False
        mesh = make_mesh((1, 2), devices=["cpu"] * 2)
        for cls in (ShardedFlatIndex, ShardedGraphIndex, ShardedIvfIndex,
                    ShardedIvf8Index):
            assert cls(vecs, mesh).search(vecs[:1], k=3)[0][0, 0] == 0
        s = IndexSearcher.load(base + "2", sharded=True,
                               device=["cpu"] * 2)
        assert isinstance(s.backend, ShardedSearcher)
        assert shardfile.load_shards(base + "2", 2) is not None
        assert sniff_foreign_index(os.path.dirname(base)) is None
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


def test_unported_backends_raise(tmp_path, monkeypatch):
    """Every backend is ported now: sharded search serves (one shard on
    the one device given); the ivf backend builds and loads, and under
    LEANN_IVF_ENGINE=pq it serves the IVF-PQ engine."""
    base = str(tmp_path / "i" / "documents.leann")
    vecs = _build(IndexBuilder, base, _texts(50), "flat", device="cpu")
    sharded = IndexSearcher.load(base, sharded=True, device="cpu")
    assert type(sharded.backend).__name__ == "ShardedSearcher"
    assert sharded.backend.n_shards == 1
    assert sharded.search(vecs[:1])[0][0].id == "d0"
    ivf = str(tmp_path / "ivf" / "documents.leann")
    _build(IndexBuilder, ivf, _texts(50), "ivf", device="cpu")
    assert IndexSearcher.load(ivf, device="cpu").backend.engine.n == 50
    monkeypatch.setenv("LEANN_IVF_ENGINE", "pq")
    engine = IndexSearcher.load(ivf, device="cpu").backend.engine
    assert type(engine).__name__ == "IvfPqEngine" and engine.n == 50


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


def test_foreign_index_detection(tmp_path):
    """The port's sniff gives the reference's diagnosis, word for word, on
    FAISS magics, a usearch file (magic at offset 0, or after a u32
    vector-matrix section) and unknown bytes."""
    import struct

    from leann_tpu.backend.compat import sniff_foreign_index as jax_sniff
    from leann_tpu_torch.backend.compat import sniff_foreign_index

    d = tmp_path / "idx"
    d.mkdir()
    assert sniff_foreign_index(str(d)) is None is jax_sniff(str(d))
    path = d / "documents.leann.index"
    path.write_bytes(b"IxF2" + b"\x00" * 64)
    msg = sniff_foreign_index(str(d))
    assert msg is not None and "FAISS" in msg and "--force" in msg
    assert msg == jax_sniff(str(d))
    path.write_bytes(b"usearch-binary-here")
    msg = sniff_foreign_index(str(d))
    assert "usearch" in msg and "reindex" in msg
    assert msg == jax_sniff(str(d))
    path.write_bytes(struct.pack("<II", 2, 4) + b"\x01" * 8 + b"usearch"
                     + b"\x00" * 64)
    assert "reindex" in sniff_foreign_index(str(d))
    assert sniff_foreign_index(str(d)) == jax_sniff(str(d))
    path.write_bytes(b"\x07" * 40)
    msg = sniff_foreign_index(str(d))
    assert "usearch (leann-rs)" in msg and "--force" in msg
    assert msg == jax_sniff(str(d))


def test_load_searcher_raises_on_foreign_index(tmp_path):
    """A graph meta with no graph file beside a FAISS `.index` raises the
    reference's RuntimeError instead of serving exact search; with no
    foreign file it still degrades to exact search."""
    from leann_tpu.backend import load_searcher as jax_load_searcher
    from leann_tpu.store.meta import IndexMeta as JaxIndexMeta
    from leann_tpu_torch.backend import FlatSearcher, load_searcher
    from leann_tpu_torch.store.embeddings import EmbeddingsWriter
    from leann_tpu_torch.store.meta import IndexMeta

    base = str(tmp_path / "documents.leann")
    with EmbeddingsWriter(base, 8) as w:
        w.add(np.zeros((4, 8), np.float32))
    meta = IndexMeta(backend_name="hnsw", dimensions=8)
    assert isinstance(load_searcher(base, meta, device="cpu"), FlatSearcher)
    (tmp_path / "documents.leann.index").write_bytes(b"IxFl" + b"\x00" * 16)
    with pytest.raises(RuntimeError, match="FAISS") as got:
        load_searcher(base, meta, device="cpu")
    with pytest.raises(RuntimeError) as want:
        jax_load_searcher(base, JaxIndexMeta(backend_name="hnsw",
                                             dimensions=8))
    assert str(got.value) == str(want.value)
