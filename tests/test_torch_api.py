"""The port's library surface (`leann_tpu_torch.api`: `Index`,
`open_index`, `store/locate.py`) against the reference's
(`leann_tpu.api`) on the CPU: JAX on the 8 virtual CPU devices of
tests/conftest.py, the port with `device="cpu"` (or `["cpu"] * 8` for a
sharded mesh).

- (a) `tests/test_api.py`'s 7 cases on the port.
- (b) One index per backend (flat, hnsw, ivf; fake embedder, 300
  passages with metadata) built by the reference's `IndexBuilder` and
  opened by both packages' `Index`: text search with hybrid off, auto
  hybrid on a short query, query expansion (the same rewritten string
  through `on_expand`), a filter DSL string, and `search_vectors` on a
  batch.
- (c) An index built by either package's builder, opened by both.
- (d) Pruned: a `local-tiny` hnsw index with its token sidecar (the port
  picks `GraphRecomputeSearcher`) and a `local-tiny` flat index with no
  graph (`RecomputeSearcher`).
- (e) `Index(base, sharded=True, device=["cpu"] * 8)`.
- (f) Without CUDA the default device raises at the first search.
- (g) `find_index` / `index_base` / `list_indexes` for a local name, a
  literal path and a global name under a monkeypatched HOME and working
  directory.

Tolerances: ids equal and scores within 1e-5 absolute (both packages
score the same stored f32 vectors; where scores tie within 1e-5 the
tied ids are compared as a set). Pruned indexes re-embed with the tiny
BERT on each side: ids equal, scores within 1e-4 (both encoders round
each product's operands to bf16 and sum in float32 in another order, as
in tests/test_torch_recompute.py)."""

import os

import numpy as np
import pytest
import torch

import leann_tpu
from leann_tpu.api import Index as JaxIndex
import leann_tpu_torch
from leann_tpu.embed import EmbeddingProvider as JaxProvider
from leann_tpu.index.builder import IndexBuilder as JaxIndexBuilder
from leann_tpu_torch.api import Index
from leann_tpu_torch.embed import EmbeddingProvider
from leann_tpu_torch.index.builder import IndexBuilder

torch.set_num_threads(1)

D = 128
N = 300
VOCAB = [
    "graph", "search", "vector", "index", "records", "beam", "merge",
    "prune", "hybrid", "filter", "kernel", "shard", "encoder", "token",
    "passage", "cluster", "bucket", "probe", "recall", "latency",
    "storage", "memory", "compute", "device", "batch", "query", "score",
    "ranking", "neighbor", "distance", "embedding", "chunker", "library",
    "server", "agent", "answer", "prompt", "context", "window", "stream",
]
TOPICS = ["graphs", "buckets", "encoders", "ranking", "serving"]


def _corpus(n=N, seed=5):
    rng = np.random.default_rng(seed)
    texts = [f"passage {i} about {TOPICS[i % 5]}: "
             + " ".join(rng.choice(VOCAB, 12)) for i in range(n)]
    meta = [{"n": i, "topic": TOPICS[i % 5], "source": f"src/f{i % 7}.py"}
            for i in range(n)]
    return texts, meta


def _build(builder_cls, base, backend, n=N, dim=D, **kw):
    texts, meta = _corpus(n)
    vecs = JaxProvider(mode="fake", dimensions=dim).embed(texts)
    b = builder_cls(base, dim=dim, backend=backend, metric="ip", **kw)
    for i, (t, v, m) in enumerate(zip(texts, vecs, meta)):
        b.add(f"d{i}", t, v, m)
    b.build(graph_degree=16, complexity=32)
    return texts, np.asarray(vecs)


def _assert_same(got, want, atol=1e-5):
    """One query's hits: the same length, scores within atol, ids equal
    where the scores are distinct and equal as a set within a run of
    scores tied within atol; a hit's text and metadata equal."""
    assert len(got) == len(want), ([h.id for h in got], [h.id for h in want])
    gs = np.array([h.score for h in got], np.float64)
    ws = np.array([h.score for h in want], np.float64)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=atol)
    i = 0
    while i < len(want):
        j = i + 1
        while j < len(want) and abs(ws[j] - ws[j - 1]) <= atol:
            j += 1
        assert {h.id for h in got[i:j]} == {h.id for h in want[i:j]}, (
            [h.id for h in got], [h.id for h in want])
        i = j
    by_id = {h.id: (h.text, h.metadata) for h in want}
    assert all(by_id[h.id] == (h.text, h.metadata) for h in got)


# ------------------------------------------------------------- (a) test_api


DOCS = [
    ("doc0", "the quick brown fox jumps over the lazy dog", {"kind": "animal"}),
    ("doc1", "tensor processing units accelerate matrix multiplication", {"kind": "hw"}),
    ("doc2", "vector databases store embeddings for retrieval", {"kind": "db"}),
    ("doc3", "foxes are small omnivorous mammals", {"kind": "animal"}),
    ("doc4", "JAX compiles numerical programs with XLA", {"kind": "hw"}),
    ("doc5", "approximate nearest neighbor search trades recall for speed", {"kind": "db"}),
]


@pytest.fixture()
def built_dir(tmp_path):
    """The reference test's flat index, built by the port."""
    index_dir = tmp_path / "indexes" / "apitest"
    base = str(index_dir / "documents.leann")
    provider = EmbeddingProvider(mode="fake", dimensions=32)
    builder = IndexBuilder(base, dim=32, backend="flat", metric="ip",
                           device="cpu")
    for (pid, text, md), v in zip(
            DOCS, provider.embed([t for _, t, _ in DOCS])):
        builder.add(pid, text, v, md)
    builder.build()
    return str(index_dir), provider


def test_lazy_exports():
    assert leann_tpu_torch.Index is Index
    assert callable(leann_tpu_torch.open_index)
    assert leann_tpu_torch.SearchResult.__module__ == \
        "leann_tpu_torch.index.searcher"
    with pytest.raises(AttributeError):
        leann_tpu_torch.nonexistent_symbol


def test_open_by_path_and_introspect(built_dir):
    index_dir, _ = built_dir
    idx = leann_tpu_torch.Index.open(index_dir, device="cpu")
    assert len(idx) == len(DOCS)
    assert idx.backend_name == "flat"
    assert not idx.is_pruned


def test_open_missing_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        leann_tpu_torch.Index.open("definitely-not-an-index", device="cpu")


def test_text_search_roundtrip(built_dir):
    index_dir, _ = built_dir
    idx = leann_tpu_torch.open_index(index_dir, device="cpu")
    hits = idx.search(DOCS[2][1], top_k=3, hybrid=False, expand=False)
    assert hits[0].id == "doc2"
    assert hits[0].metadata == {"kind": "db"}
    assert hits[0].score > 0.99


def test_filter_dsl_string(built_dir):
    index_dir, _ = built_dir
    idx = leann_tpu_torch.open_index(index_dir, device="cpu")
    hits = idx.search(DOCS[0][1], top_k=4, filter="kind=animal",
                      hybrid=False, expand=False)
    assert hits and all(h.metadata["kind"] == "animal" for h in hits)


def test_auto_hybrid_short_query(built_dir):
    """A short keyword query auto-enables vector+BM25 fusion; weighted
    to BM25, the exact-keyword doc ranks first."""
    index_dir, _ = built_dir
    idx = leann_tpu_torch.open_index(index_dir, device="cpu")
    hits = idx.search("lazy dog", top_k=2, expand=False, hybrid_alpha=0.2)
    assert hits[0].id == "doc0"
    flat = idx.search("lazy dog", top_k=2, expand=False, hybrid=False)
    assert [h.id for h in flat] != [h.id for h in hits] or flat[0].id == "doc0"


def test_search_vectors_batched(built_dir):
    index_dir, provider = built_dir
    idx = leann_tpu_torch.open_index(index_dir, device="cpu")
    q = np.asarray(provider.embed([DOCS[1][1], DOCS[5][1]]))
    out = idx.search_vectors(q, top_k=2)
    assert len(out) == 2
    assert out[0][0].id == "doc1"
    assert out[1][0].id == "doc5"


# ------------------------------------------------------------- (b) backends


_OPENED = {}


@pytest.fixture(scope="module")
def opened(tmp_path_factory):
    """backend -> (texts, vectors, reference Index, port Index) over one
    reference-built index per backend, built and opened once."""

    def get(backend):
        if backend not in _OPENED:
            root = tmp_path_factory.mktemp(backend)
            base = str(root / "indexes" / backend / "documents.leann")
            texts, vecs = _build(JaxIndexBuilder, base, backend)
            _OPENED[backend] = (texts, vecs, JaxIndex(base),
                                Index(base, device="cpu"), base)
        return _OPENED[backend]

    yield get
    _OPENED.clear()


PICK = [3, 77, 250]


def check_plain(texts, vecs, ref, port):
    for i in PICK:
        want = ref.search(texts[i], top_k=10, hybrid=False, expand=False)
        got = port.search(texts[i], top_k=10, hybrid=False, expand=False)
        assert got[0].id == f"d{i}"
        _assert_same(got, want)


def check_auto_hybrid(texts, vecs, ref, port):
    for q in ("beam merge", "shard encoder token"):
        want = ref.search(q, top_k=10, expand=False, hybrid_alpha=0.2)
        got = port.search(q, top_k=10, expand=False, hybrid_alpha=0.2)
        _assert_same(got, want)
        assert not _ids(got) == _ids(port.search(
            q, top_k=10, expand=False, hybrid=False))


def check_expand(texts, vecs, ref, port):
    seen = {"ref": [], "port": []}
    for q in ("recall latency", "graphs"):
        want = ref.search(q, top_k=10, on_expand=seen["ref"].append)
        got = port.search(q, top_k=10, on_expand=seen["port"].append)
        _assert_same(got, want)
    assert len(seen["port"]) == 2 and seen["port"] == seen["ref"]
    assert seen["port"][0].startswith("recall latency ")


def check_filter(texts, vecs, ref, port):
    flt = "topic=graphs AND n<200"
    for i in (5, 100):
        want = ref.search(texts[i], top_k=10, filter=flt, hybrid=False,
                          expand=False)
        got = port.search(texts[i], top_k=10, filter=flt, hybrid=False,
                          expand=False)
        assert got and all(h.metadata["topic"] == "graphs"
                           and h.metadata["n"] < 200 for h in got)
        assert got[0].id == f"d{i}"
        _assert_same(got, want)


def check_vectors(texts, vecs, ref, port):
    q = vecs[[1, 42, 99, 150, 299]] + np.float32(0.01)
    want = ref.search_vectors(q, top_k=10)
    got = port.search_vectors(q, top_k=10)
    assert [r[0].id for r in got] == ["d1", "d42", "d99", "d150", "d299"]
    for g, w in zip(got, want):
        _assert_same(g, w)


def _ids(hits):
    return [h.id for h in hits]


CHECKS = [check_plain, check_auto_hybrid, check_expand, check_filter,
          check_vectors]


@pytest.mark.parametrize("check", CHECKS, ids=lambda f: f.__name__[6:])
@pytest.mark.parametrize("backend", ["flat", "hnsw", "ivf"])
def test_index_matches_reference(opened, backend, check):
    texts, vecs, ref, port, _ = opened(backend)
    check(texts, vecs, ref, port)


# ------------------------------------------------------------- (c) cross-built


@pytest.mark.parametrize("builder", ["port", "reference"])
def test_index_built_by_either_package_searches_in_both(tmp_path, builder):
    base = str(tmp_path / "indexes" / "x" / "documents.leann")
    if builder == "port":
        texts, vecs = _build(IndexBuilder, base, "hnsw", n=200, device="cpu")
    else:
        texts, vecs = _build(JaxIndexBuilder, base, "hnsw", n=200)
    ref, port = JaxIndex(base), Index(base, device="cpu")
    for i in (0, 17, 199):
        want = ref.search(texts[i], top_k=5, hybrid=False, expand=False)
        got = port.search(texts[i], top_k=5, hybrid=False, expand=False)
        assert got[0].id == f"d{i}"
        _assert_same(got, want)
    q = vecs[[3, 60, 120]]
    for g, w in zip(port.search_vectors(q, top_k=5),
                    ref.search_vectors(q, top_k=5)):
        _assert_same(g, w)


# ------------------------------------------------------------- (d) pruned


@pytest.fixture(scope="module")
def pruned_base(tmp_path_factory):
    """backend -> a reference-built `local-tiny` index (token sidecar),
    pruned as the reference's `prune` command prunes it."""
    from leann_tpu.index.builder import StreamingIndexBuilder
    from leann_tpu.models.bert import BertConfig, BertEncoder
    from leann_tpu.store.embeddings import prune_embeddings
    from leann_tpu.store.meta import IndexMeta, meta_path
    from leann_tpu.store.passages import Passage

    texts = [f"document {i} topic {i % 13} flavor {i % 7}" for i in range(240)]
    provider = JaxProvider(mode="local", model="local-tiny")
    vecs = provider.embed(texts)
    out = {}
    for backend in ("hnsw", "flat"):
        base = str(tmp_path_factory.mktemp(f"pruned_{backend}") / "indexes"
                   / "p" / "documents.leann")
        b = StreamingIndexBuilder(
            base, dim=vecs.shape[1], backend=backend, metric="ip",
            embedding_model="local-tiny", embedding_mode="local",
            is_recompute=True,
            tokenizer_encoder=BertEncoder(config=BertConfig.tiny()))
        for i, (t, v) in enumerate(zip(texts, vecs)):
            b.add_passage(Passage(id=f"p{i}", text=t,
                                  metadata={"facet": i % 7}), v)
        b.build(graph_degree=12, complexity=24)
        assert prune_embeddings(base)
        meta = IndexMeta.load(meta_path(base))
        meta.is_pruned = True
        meta.save(meta_path(base))
        out[backend] = base
    return texts, out


@pytest.mark.parametrize("backend,searcher", [
    ("hnsw", "GraphRecomputeSearcher"), ("flat", "RecomputeSearcher")])
def test_pruned_index_picks_recompute_searcher(pruned_base, backend,
                                               searcher):
    from leann_tpu_torch.index import recompute

    texts, bases = pruned_base
    ref = JaxIndex(bases[backend])
    port = Index(bases[backend], device="cpu")
    assert port.is_pruned
    for i in (5, 150):
        want = ref.search(texts[i], top_k=5, complexity=24)
        got = port.search(texts[i], top_k=5, complexity=24)
        assert got[0].id == f"p{i}"
        assert _ids(got) == _ids(want)
        np.testing.assert_allclose([h.score for h in got],
                                   [h.score for h in want], rtol=0, atol=1e-4)
    assert type(port._recompute_searcher()) is getattr(recompute, searcher)
    flt = "facet=3"
    want = ref.search(texts[10], top_k=5, filter=flt)
    got = port.search(texts[10], top_k=5, filter=flt)
    assert got[0].id == "p10" and all(h.metadata["facet"] == 3 for h in got)
    assert _ids(got) == _ids(want)
    # the provider's encoder and the searcher sit on the device asked for
    assert port.provider._impl.encoder.device == torch.device("cpu")


# ------------------------------------------------------------- (e) sharded


@pytest.mark.parametrize("backend", ["flat", "ivf"])
def test_sharded_index_matches_reference(opened, backend):
    """The port lays one shard per listed device; the reference over the
    8 virtual CPU devices. The first to load writes `.shards.npz`, the
    other reads it."""
    texts, vecs, _, _, base = opened(backend)
    ref = JaxIndex(base, sharded=True)
    port = Index(base, sharded=True, device=["cpu"] * 8)
    want = ref.search(texts[42], top_k=10, hybrid=False, expand=False)
    got = port.search(texts[42], top_k=10, hybrid=False, expand=False)
    assert type(port._stored_searcher().backend).__name__ == "ShardedSearcher"
    assert port._stored_searcher().backend.n_shards == 8
    assert got[0].id == "d42"
    _assert_same(got, want)
    q = vecs[[7, 8, 280]]
    for g, w in zip(port.search_vectors(q, top_k=10),
                    ref.search_vectors(q, top_k=10)):
        _assert_same(g, w)


# ------------------------------------------------------------- (f) no CUDA


def test_default_device_raises_without_cuda(built_dir):
    """`device=None` means cuda: opening reads only host files, and the
    first call that needs the device raises, naming device='cpu'.
    Nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the missing-CUDA error; CUDA exists here")
    index_dir, provider = built_dir
    idx = leann_tpu_torch.Index.open(index_dir)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        idx.search(DOCS[2][1], hybrid=False, expand=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        idx.search_vectors(provider.embed([DOCS[1][1]]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Index.open(index_dir, sharded=True).search("fox", expand=False)


# ------------------------------------------------------------- (g) locate


def _fake_index(d):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "documents.leann.meta.json"), "w") as f:
        f.write("{}")


@pytest.mark.parametrize("kind", ["local", "literal", "global", "missing"])
def test_locate_matches_reference(tmp_path, monkeypatch, kind):
    from leann_tpu.store import locate as jloc
    from leann_tpu_torch.store import locate as tloc

    home, cwd = tmp_path / "home", tmp_path / "work"
    monkeypatch.setenv("HOME", str(home))
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    _fake_index(str(cwd / ".leann" / "indexes" / "mine"))
    _fake_index(str(home / ".leann" / "indexes" / "theirs"))
    _fake_index(str(tmp_path / "elsewhere" / "lit"))
    name = {"local": "mine", "literal": str(tmp_path / "elsewhere" / "lit"),
            "global": "theirs", "missing": "absent"}[kind]
    if kind == "missing":
        with pytest.raises(FileNotFoundError) as want:
            jloc.find_index(name)
        with pytest.raises(FileNotFoundError) as got:
            tloc.find_index(name)
        assert str(got.value) == str(want.value)
        return
    got, want = tloc.find_index(name), jloc.find_index(name)
    assert got == want
    assert os.path.realpath(got).startswith(str(
        {"local": cwd, "literal": tmp_path, "global": home}[kind]))
    assert tloc.index_base(got) == jloc.index_base(want)
    assert tloc.list_indexes() == jloc.list_indexes()
