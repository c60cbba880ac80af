"""The port's native C++ host runtime (`leann_tpu_torch/native/`, built
from `leann_tpu_torch/csrc/leann_native.cpp`) against the reference's
(`leann_tpu/native/`) and against the Python BM25 build, the oracle.

Tolerances: none. The postings arrays and the saved `.bm25.npz` files
must be equal exactly (bytes for the files); scores of the mirrored
reference cases keep `tests/test_native.py`'s rtol of 1e-5."""

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from leann_tpu.index.bm25 import Bm25Scorer as JaxBm25
from leann_tpu.native import bm25_build_native as jax_bm25_build_native
from leann_tpu_torch import native
from leann_tpu_torch.index.bm25 import Bm25Scorer
from leann_tpu_torch.native import _load_lib, bm25_build_native
from leann_tpu_torch.ops._cuda import BUILD_DIR, CSRC_DIR
from leann_tpu_torch.utils import METRICS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DOCS = [
    "The quick brown fox jumps over the lazy dog",
    "a fast auburn fox leaped over sleeping hounds",
    "Ünïcode façade text with ascii tokens inside 42x",
    "",
    "repeated repeated repeated token token",
]

ARRAYS = ("vocab", "offsets", "post_docs", "post_tfs", "doc_lengths")


def _seeded_corpus(n=2000, seed=5):
    """Empty texts, non-ASCII words, one-character tokens, mixed case and
    digits glued to letters."""
    rng = np.random.default_rng(seed)
    words = np.array(
        [f"w{i}" for i in range(300)]
        + ["Ünïcode", "façade", "naïve", "日本語", "αβγ", "x", "Y", "7", "a",
           "Tok2", "tok2", "ABC", "abc", "e-mail", "C++", "3.14", "ß"])
    out = []
    for i in range(n):
        if i % 97 == 0:
            out.append("")
            continue
        out.append(" ".join(rng.choice(words, int(rng.integers(1, 30)))))
    return out


CORPORA = {"docs": DOCS, "seeded2000": _seeded_corpus()}


def _counter(name):
    return METRICS.snapshot().get(name, {}).get("value", 0.0)


def _assert_equal_arrays(a, b):
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.fixture(scope="module")
def native_lib():
    lib = _load_lib()
    if lib is None:
        pytest.skip("native library unavailable (g++ build failed)")
    return lib


# ------------------------------------ tests/test_native.py on the port


def test_native_build_matches_python(native_lib):
    native_scorer = Bm25Scorer(*bm25_build_native(DOCS))
    python = Bm25Scorer._build_python(DOCS)
    assert native_scorer.num_docs == python.num_docs
    np.testing.assert_array_equal(native_scorer.doc_lengths,
                                  python.doc_lengths)
    assert native_scorer.vocab.tolist() == python.vocab.tolist()
    for query in ("fox dog", "repeated token", "42x", "nothing matches"):
        np.testing.assert_allclose(
            native_scorer.score_query(query), python.score_query(query),
            rtol=1e-5)


def test_native_build_used_by_default(native_lib):
    before = _counter("bm25.build.native")
    scorer = Bm25Scorer.build(DOCS)
    assert _counter("bm25.build.native") == before + 1
    oracle = Bm25Scorer._build_python(DOCS)
    np.testing.assert_allclose(
        scorer.score_query("fox dog"), oracle.score_query("fox dog"),
        rtol=1e-5)


def test_native_scales(native_lib):
    docs = [f"document {i} token{i % 97} shared words here"
            for i in range(5000)]
    scorer = Bm25Scorer(*bm25_build_native(docs))
    assert scorer.num_docs == 5000
    hits = scorer.search("token11", 5)
    assert hits
    assert all(i % 97 == 11 for i, _ in hits)


def test_scan_line_offsets(native_lib):
    buf = b'{"a":1}\n{"b":2}\n{"c":3}\n'
    out = np.zeros(10, dtype=np.int64)
    n = native_lib.scan_line_offsets(
        buf, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), 10)
    assert n == 3
    np.testing.assert_array_equal(out[:3], [0, 8, 16])


# ------------------------------------------- parity with the reference


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_native_arrays_equal_reference_and_oracle(native_lib, corpus):
    texts = CORPORA[corpus]
    mine = Bm25Scorer(*bm25_build_native(texts))
    ref_native = jax_bm25_build_native(texts)
    if ref_native is None:
        pytest.skip("the reference's native library is unavailable")
    _assert_equal_arrays(mine, JaxBm25(*ref_native))
    _assert_equal_arrays(mine, JaxBm25._build_python(texts))
    _assert_equal_arrays(mine, Bm25Scorer._build_python(texts))


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_saved_sidecar_byte_equal_across_packages(native_lib, tmp_path,
                                                  corpus):
    texts = CORPORA[corpus]
    mine, ref = str(tmp_path / "t.bm25.npz"), str(tmp_path / "j.bm25.npz")
    Bm25Scorer.build(texts).save(mine)
    JaxBm25.build(texts).save(ref)
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


# --------------------------------------------- where the library lives


def _so_files(root):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                  for f in fs if ".so" in f)


def test_library_built_in_build_dir_once(native_lib, tmp_path):
    src = os.path.join(CSRC_DIR, "leann_native.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = native._compiled_lib_path()
    assert path == os.path.join(BUILD_DIR, f"libleann_native-{digest}.so")
    mtime = os.stat(path).st_mtime_ns
    ref_dirs = [os.path.join(REPO, "leann_tpu"), os.path.join(REPO, "native")]
    before = [_so_files(d) for d in ref_dirs]

    # a fresh interpreter loads the built library: no g++, same file; it
    # reads and writes none of the reference's cache directories
    cache = tmp_path / "cache"
    code = textwrap.dedent("""
        import subprocess, sys
        def run(cmd, *a, **k):
            raise AssertionError(f"compiled again: {cmd}")
        subprocess.run = run
        from leann_tpu_torch import native
        lib = native._load_lib()
        assert lib is not None
        assert native.bm25_build_native(["hello world"])[0].tolist() == [
            "hello", "world"]
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "leann_tpu" or m.startswith("leann_tpu.")
               or m == "torch"]
        assert not bad, bad
        print(native._compiled_lib_path())
    """)
    env = dict(os.environ, PYTHONPATH=REPO, HOME=str(tmp_path / "home"),
               XDG_CACHE_HOME=str(cache), LEANN_NATIVE_CACHE=str(cache))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == path
    assert os.stat(path).st_mtime_ns == mtime
    assert not cache.exists() and not (tmp_path / "home").exists()
    assert [_so_files(d) for d in ref_dirs] == before == [[], []]


# ------------------------------------------------ the Python fallback


def test_without_gpp_falls_back_to_python(monkeypatch):
    real_which = shutil.which
    monkeypatch.setattr(shutil, "which",
                        lambda name, *a, **k: None if name == "g++"
                        else real_which(name, *a, **k))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_CHECKED", False)
    assert bm25_build_native(DOCS) is None
    before = (_counter("bm25.build.native"), _counter("bm25.build.python"))
    scorer = Bm25Scorer.build(DOCS)
    assert (_counter("bm25.build.native"),
            _counter("bm25.build.python")) == (before[0], before[1] + 1)
    _assert_equal_arrays(scorer, Bm25Scorer._build_python(DOCS))


def test_native_exception_is_counted_and_logged(native_lib, monkeypatch,
                                                caplog):
    from leann_tpu_torch.native import bm25_bridge

    def boom(lib, documents):
        raise RuntimeError("postings export failed")

    monkeypatch.setattr(bm25_bridge, "build_postings", boom)
    caplog.set_level(logging.WARNING, logger="leann_tpu_torch")
    before = (_counter("bm25.build.native"), _counter("bm25.build.python"))
    scorer = Bm25Scorer.build(DOCS)
    assert (_counter("bm25.build.native"),
            _counter("bm25.build.python")) == (before[0], before[1] + 1)
    _assert_equal_arrays(scorer, Bm25Scorer._build_python(DOCS))
    warned = [r for r in caplog.records if r.levelno == logging.WARNING
              and "RuntimeError" in r.getMessage()]
    assert warned, [r.getMessage() for r in caplog.records]


# ------------------------------------- indexes built by either package


@pytest.mark.parametrize("builder", ["jax", "torch"])
def test_hybrid_search_across_packages(native_lib, tmp_path, builder):
    """An index built by one package's StreamingIndexBuilder (each through
    its native BM25 build) is searched in hybrid mode by both packages:
    equal ids; the two packages' sidecars are byte-equal."""
    from leann_tpu.index import IndexSearcher as JaxSearcher
    from leann_tpu.index import SearchOptions as JaxOptions
    from leann_tpu.index import StreamingIndexBuilder as JaxBuilder
    from leann_tpu.store.passages import Passage as JaxPassage
    from leann_tpu_torch.embed.fake import FakeEmbedding
    from leann_tpu_torch.index import (
        IndexSearcher, SearchOptions, StreamingIndexBuilder,
    )
    from leann_tpu_torch.store.passages import Passage

    texts = _seeded_corpus(300, seed=9)
    vecs = FakeEmbedding(64).embed(texts)
    bases = {}
    for pkg in ("jax", "torch"):
        bases[pkg] = str(tmp_path / pkg / "documents.leann")
        if pkg == "jax":
            b, passage = JaxBuilder(bases[pkg], dim=64, backend="hnsw"), \
                JaxPassage
        else:
            b, passage = StreamingIndexBuilder(
                bases[pkg], dim=64, backend="hnsw", device="cpu"), Passage
        for i, (t, v) in enumerate(zip(texts, vecs)):
            b.add_passage(passage(id=f"d{i}", text=t, metadata={}), v)
        before = _counter("bm25.build.native")
        b.build(graph_degree=16, complexity=32)
        if pkg == "torch":
            assert _counter("bm25.build.native") == before + 1
    with open(bases["jax"] + ".bm25.npz", "rb") as a, \
            open(bases["torch"] + ".bm25.npz", "rb") as b:
        assert a.read() == b.read()

    base = bases[builder]
    q = FakeEmbedding(64).embed(["w3 w17 naïve", "Tok2 abc"])
    queries = [texts[11], "w5 w250 façade"]
    mine = IndexSearcher.load(base, device="cpu")
    ref = JaxSearcher.load(base)
    for vec, text in zip(q, queries):
        got = mine.search(vec[None], SearchOptions(
            top_k=5, hybrid=True, query_text=text))[0]
        want = ref.search(vec[None], JaxOptions(
            top_k=5, hybrid=True, query_text=text))[0]
        assert len(got) == 5
        assert [r.id for r in got] == [r.id for r in want]


def test_every_call_site_builds_natively(native_lib, tmp_path, monkeypatch):
    """The CLI's `build` (StreamingIndexBuilder), `update`, `reindex
    --rebuild-bm25` and IndexSearcher's in-memory build when the sidecar
    is missing each build once through the native path, none in Python;
    each sidecar equals the oracle's."""
    from leann_tpu_torch.cli.main import main
    from leann_tpu_torch.index import IndexSearcher
    from leann_tpu_torch.store.passages import PassageStore

    docs = tmp_path / "docs"
    docs.mkdir()
    texts = _seeded_corpus(40, seed=3)
    for i, t in enumerate(texts[:30]):
        (docs / f"p{i}.txt").write_text(t or "empty")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "home" / ".config"))
    monkeypatch.setenv("LEANN_TORCH_DEVICE", "cpu")
    base = str(tmp_path / ".leann" / "indexes" / "t" / "documents.leann")

    def sidecar_is_oracle():
        ids = [ln.rstrip("\n") for ln in open(base + ".ids.txt")]
        by_id = {p.id: p.text for p in PassageStore(base).iter_all()}
        oracle = Bm25Scorer._build_python([by_id[i] for i in ids])
        _assert_equal_arrays(Bm25Scorer.load(base + ".bm25.npz"), oracle)

    def builds(step):
        before = (_counter("bm25.build.native"),
                  _counter("bm25.build.python"))
        step()
        return (_counter("bm25.build.native") - before[0],
                _counter("bm25.build.python") - before[1])

    assert builds(lambda: main([
        "build", "t", "--docs", "docs", "--embedding-mode", "fake",
        "--embedding-dimensions", "32", "--backend-name", "flat"])) == (1, 0)
    sidecar_is_oracle()
    for i, t in enumerate(texts[30:]):
        (docs / f"u{i}.txt").write_text(t or "empty")
    assert builds(lambda: main(["update", "t", "--docs", "docs"])) == (1, 0)
    sidecar_is_oracle()
    assert builds(lambda: main(["reindex", "t", "--backend-name", "flat",
                                "--rebuild-bm25"])) == (1, 0)
    sidecar_is_oracle()
    saved = Bm25Scorer.load(base + ".bm25.npz")
    os.remove(base + ".bm25.npz")
    searcher = IndexSearcher.load(base, device="cpu")
    assert builds(searcher.bm25) == (1, 0)
    _assert_equal_arrays(searcher.bm25(), saved)
