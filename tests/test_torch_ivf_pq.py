"""Parity of the port's IVF-PQ engine (`leann_tpu_torch/ops/ivf_pq.py`)
and the `IvfSearcher` branch that picks it with the JAX reference
(`leann_tpu/ops/ivf_pq.py`, `leann_tpu/backend`), on the CPU.

Tolerances:
- `pack_pq_buckets`: byte-equal;
- the stored |x_hat|^2 column: rtol 1e-5 / atol 1e-4 against the
  reference's on the same codes (float32 table sums in another order);
- searches of an engine made by `state_from_reference` (the reference's
  own tables): ids equal row for row wherever the exact 10th and 11th
  scores differ by more than 1e-4, scores within rtol 1e-5 / atol 1e-4,
  and at least 9 of 10 ids in common on every row;
- an engine built by the port's own constructor on the reference's
  centers: recall@10 >= 0.9 against the exact oracle (the reference
  test's bar), rescored scores exact to rtol 1e-4;
- calibrated nprobe equal, its recall within 0.02."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from leann_tpu.ops import ivf_pq as jpq
from leann_tpu.ops.distance import exact_topk as jexact_topk
from leann_tpu.ops.ivf import kmeans as jkmeans
from leann_tpu_torch.ops import ivf_pq as tpq

torch.set_num_threads(1)


def clustered(n=3000, d=32, k=24, seed=0):
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.standard_normal((k, d)).astype(np.float32)
    x = centers[rng.integers(0, k, n)] + rng.standard_normal(
        (n, d)).astype(np.float32)
    return np.ascontiguousarray(x, np.float32)


def recall(idx, oracle):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / oracle.shape[1]
                    for a, b in zip(np.asarray(idx), np.asarray(oracle))])


def ref_arrays(ref, metric):
    """The reference engine's tables as numpy, for `state_from_reference`."""
    def host(a):
        return None if a is None else np.asarray(a)

    return dict(
        bucket_ids=host(ref.bucket_ids), bucket_cent=host(ref.bucket_cent),
        bucket_codes=host(ref.bucket_codes), bucket_nsq=host(ref.bucket_nsq),
        books=host(ref.books), corpus=host(ref.corpus),
        corpus_nsq=host(ref.corpus_nsq), corpus_scale=host(ref.corpus_scale),
        corpus_cent=host(ref.corpus_cent),
        corpus_assign=host(ref.corpus_assign), rotation=ref.rotation,
        metric=metric, n=ref.n, centers=np.asarray(ref.centers),
        assign=np.asarray(ref.assign))


def queries_near(x, count, seed):
    rng = np.random.default_rng(seed)
    return x[rng.integers(0, len(x), count)] + 0.05 * rng.standard_normal(
        (count, x.shape[1])).astype(np.float32)


@pytest.mark.parametrize("cap", [None, 40])
def test_pack_pq_buckets_byte_equal(cap):
    x = clustered(n=700, d=24, k=8, seed=4)
    rng = np.random.default_rng(5)
    centers, assign = (np.asarray(a) for a in jkmeans(x, 8, iters=4,
                                                      metric="l2", seed=0))
    codes = rng.integers(0, 256, (700, 6)).astype(np.uint8)
    nsq = rng.random(700).astype(np.float32)
    got = tpq.pack_pq_buckets(assign, codes, nsq, centers, 700, cap)
    want = jpq.pack_pq_buckets(assign, codes, nsq, centers, 700, cap)
    if cap:
        assert got[0].shape[0] > 8      # overflow buckets exist
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_stored_sq_norms_match_reference():
    """|x_hat|^2 in the decomposed form, computed on the device in
    chunks, against the reference's numpy column on the same centers,
    books and codes."""
    x = clustered(n=2000, seed=6)
    ref = jpq.IvfPqEngine(x, n_clusters=32, metric="l2", m=8, rescore="f32")
    order = np.argsort(np.asarray(ref.bucket_ids).reshape(-1),
                       kind="stable")[:len(x)]
    codes = np.asarray(ref.bucket_codes).reshape(-1, ref.m)[order]
    want = np.asarray(ref.bucket_nsq).reshape(-1)[order]
    got = tpq._reconstruction_sq_norms(
        np.asarray(ref.centers), np.asarray(ref.assign), codes, ref.books,
        torch.device("cpu"))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _separable(q, x, metric, k=10):
    sc = np.asarray(jexact_topk(q, x, k + 1, metric=metric)[0])
    return np.abs(sc[:, k - 1] - sc[:, k]) > 1e-4


def _assert_equal(got, want, rows):
    gi, gs = (np.asarray(a) for a in got)
    wi, ws = (np.asarray(a) for a in want)
    assert gi.shape == wi.shape and rows.mean() >= 0.5
    np.testing.assert_array_equal(gi[rows], wi[rows])
    np.testing.assert_allclose(gs[rows], ws[rows], rtol=1e-5, atol=1e-4)
    for a, b in zip(gi, wi):
        assert len(set(a.tolist()) & set(b.tolist())) >= 9


@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("rescore", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_search_on_reference_tables_matches_reference(metric, rescore,
                                                      rotated):
    x = clustered(seed=3)
    rot = None
    if rotated:
        rot = np.linalg.qr(np.random.default_rng(5).standard_normal(
            (32, 32)))[0].astype(np.float32)
    ref = jpq.IvfPqEngine(x, n_clusters=24, metric=metric, m=8,
                          rescore=rescore, rotation=rot, seed=0)
    eng = tpq.state_from_reference(ref_arrays(ref, metric), device="cpu")
    assert eng.rescore == rescore and eng.cap == ref.cap
    q = queries_near(x, 12, seed=4)
    want = ref.search(q, k=10, nprobe=8, rescore_factor=16)
    got = eng.search(q, k=10, nprobe=8, rescore_factor=16)
    rows = _separable(q, x, metric)
    if rescore == "int8":
        # the int8 rescore's scores carry quantization error: rank by the
        # reference's own returned scores instead of the exact ones
        ws = np.asarray(ref.search(q, k=11, nprobe=8, rescore_factor=16)[1])
        rows = np.abs(ws[:, 9] - ws[:, 10]) > 1e-4
    _assert_equal(got, want, rows)


def test_search_sentinels_and_small_corpus():
    """Fewer candidates than k: empty slots come back as id -1 with
    score -inf, as in the reference; C is clamped to cap * nprobe."""
    x = clustered(n=60, d=16, k=4, seed=8)
    ref = jpq.IvfPqEngine(x, n_clusters=8, metric="l2", m=4, ksub=16,
                          rescore="f32", seed=0)
    eng = tpq.state_from_reference(ref_arrays(ref, "l2"), device="cpu")
    q = queries_near(x, 5, seed=9)
    want = ref.search(q, k=10, nprobe=1, rescore_factor=16)
    got = eng.search(q, k=10, nprobe=1, rescore_factor=16)
    np.testing.assert_array_equal(got[0] == -1, np.asarray(want[0]) == -1)
    np.testing.assert_array_equal(np.isneginf(got[1]),
                                  np.isneginf(np.asarray(want[1])))
    assert (got[0] == -1).any()
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_own_constructor_recall_and_exact_scores(metric):
    x = clustered(n=6000, d=32, k=40, seed=0)
    centers, assign = (np.asarray(a) for a in jkmeans(
        x, 64, iters=8, metric="ip" if metric == "cosine" else metric,
        seed=0))
    if metric == "cosine":      # the engine clusters the normalized rows
        centers = assign = None
    eng = tpq.IvfPqEngine(x, n_clusters=64, metric=metric, m=8,
                          rescore="f32", seed=0, centers=centers,
                          assign=assign, device="cpu")
    rng = np.random.default_rng(1)
    q = x[rng.integers(0, len(x), 16)] + 0.05 * rng.standard_normal(
        (16, 32)).astype(np.float32)
    idx, sc = eng.search(q, k=10, nprobe=16, rescore_factor=16)
    _, oracle = jexact_topk(q, x, 10, metric=metric)
    assert recall(idx, oracle) >= 0.9
    i0 = idx[0, 0]
    if metric == "l2":
        want = 2 * float(q[0] @ x[i0]) - float(x[i0] @ x[i0])
    elif metric == "ip":
        want = float(q[0] @ x[i0])
    else:
        want = float(q[0] @ x[i0]) / float(
            np.linalg.norm(q[0]) * np.linalg.norm(x[i0]))
    np.testing.assert_allclose(sc[0, 0], want, rtol=1e-4)
    assert set(eng.build_seconds) >= {"train", "encode", "norms", "pack"}


def test_own_constructor_tables_match_reference():
    """Same centers, same seed: the port's constructor trains the same
    codebooks from the same sample (float32 k-means in another summation
    order: codes agree on >= 99% of entries) and the int8 rescore corpus
    is byte-equal."""
    x = clustered(n=2500, d=32, k=20, seed=12)
    ref = jpq.IvfPqEngine(x, n_clusters=32, metric="l2", m=8,
                          rescore="int8", seed=0)
    eng = tpq.IvfPqEngine(x, metric="l2", m=8, rescore="int8", seed=0,
                          centers=np.asarray(ref.centers),
                          assign=np.asarray(ref.assign), device="cpu")
    assert eng.corpus.numpy().tobytes() == np.asarray(ref.corpus).tobytes()
    np.testing.assert_array_equal(eng.corpus_scale.numpy(),
                                  np.asarray(ref.corpus_scale))
    np.testing.assert_array_equal(eng.corpus_nsq.numpy(),
                                  np.asarray(ref.corpus_nsq))
    np.testing.assert_array_equal(eng.bucket_ids.numpy(),
                                  np.asarray(ref.bucket_ids))
    same = (eng.bucket_codes.numpy() == np.asarray(ref.bucket_codes)).mean()
    assert same >= 0.99, same
    np.testing.assert_allclose(eng.books, ref.books, rtol=1e-3, atol=1e-3)


def test_int8_rescore_close_to_f32():
    x = clustered(n=6000, d=32, k=40, seed=2)
    q = queries_near(x, 16, seed=3)
    centers, assign = (np.asarray(a) for a in jkmeans(x, 64, iters=8,
                                                      metric="l2", seed=0))
    e32, e8 = (tpq.IvfPqEngine(x, metric="l2", m=8, rescore=r,
                               centers=centers, assign=assign, device="cpu")
               for r in ("f32", "int8"))
    assert e8.corpus.dtype == torch.int8 and e32.corpus.dtype == torch.float32
    i32, _ = e32.search(q, k=10, nprobe=16)
    i8, _ = e8.search(q, k=10, nprobe=16)
    assert recall(i8, i32) >= 0.9


@pytest.mark.parametrize("metric", ["ip", "cosine"])
def test_search_many_device_matches_single(metric):
    """Each batch goes through `search_device`, so cosine queries are
    normalized (the reference's scan passes them un-normalized and its
    cosine scores carry the factor |q|)."""
    x = clustered(n=3000, d=32, k=24, seed=7)
    eng = tpq.IvfPqEngine(x, n_clusters=48, metric=metric, m=8,
                          rescore="f32", device="cpu")
    rng = np.random.default_rng(8)
    qs = torch.from_numpy(2.0 * x[rng.integers(0, len(x), (2, 8))])
    ids_m, sc_m = eng.search_many_device(qs, k=5, nprobe=16)
    assert ids_m.shape == (2, 8, 5)
    for i in range(2):
        ids_1, sc_1 = eng.search_device(qs[i], k=5, nprobe=16)
        assert torch.equal(ids_m[i], ids_1) and torch.equal(sc_m[i], sc_1)
    if metric == "cosine":
        assert float(sc_m.max()) <= 1.0 + 1e-5


def test_search_many_device_matches_reference_ip():
    import jax.numpy as jnp

    x = clustered(n=3000, d=32, k=24, seed=7)
    ref = jpq.IvfPqEngine(x, n_clusters=48, metric="ip", m=8, rescore="f32")
    eng = tpq.state_from_reference(ref_arrays(ref, "ip"), device="cpu")
    q = x[np.random.default_rng(8).integers(0, len(x), 8)]
    want = ref.search_many_device(jnp.asarray(q[None]), k=5, nprobe=16)
    got = eng.search_many_device(torch.from_numpy(q[None]), k=5, nprobe=16)
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0][0]))
    np.testing.assert_allclose(got[1][0].numpy(), np.asarray(want[1][0]),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rescore", ["f32", "int8"])
def test_calibrate_nprobe_matches_reference(rescore):
    x = clustered(n=4000, d=32, k=32, seed=10)
    ref = jpq.IvfPqEngine(x, n_clusters=64, metric="l2", m=8,
                          rescore=rescore)
    eng = tpq.state_from_reference(ref_arrays(ref, "l2"), device="cpu")
    got = eng.calibrate_nprobe(target_recall=0.9, sample=64)
    want = ref.calibrate_nprobe(target_recall=0.9, sample=64)
    assert got[0] == want[0] and abs(got[1] - want[1]) <= 0.02
    assert got[1] >= 0.9 and 1 <= got[0] <= eng.n_clusters


def test_ivf_searcher_pq_knob(monkeypatch):
    """LEANN_IVF_ENGINE=pq routes IvfSearcher onto the ADC engine, with
    the reference's choice of rescore corpus; a row finds itself."""
    from leann_tpu.backend import IvfSearcher as JaxIvfSearcher
    from leann_tpu_torch.backend import IvfSearcher

    monkeypatch.setenv("LEANN_IVF_ENGINE", "pq")
    x = clustered(n=3000, seed=9)
    c, a = (np.asarray(t) for t in jkmeans(x, 48, iters=5, metric="l2"))
    ivf = SimpleNamespace(centers=c, assign=a)
    s = IvfSearcher(x, ivf, metric="l2", device="cpu")
    ref = JaxIvfSearcher(x, ivf, metric="l2")
    assert isinstance(s.engine, tpq.IvfPqEngine)
    assert s.engine.rescore == ref.engine.rescore == "f32"
    assert s.engine.m == ref.engine.m and len(s) == 3000
    idx, _ = s.search(x[:8], k=5, complexity=64)
    assert (idx[:, 0] == np.arange(8)).all()
    monkeypatch.delenv("LEANN_IVF_ENGINE")
    assert type(IvfSearcher(x, ivf, metric="l2",
                            device="cpu").engine).__name__ == "IvfEngine"


@pytest.mark.parametrize("built_by", ["torch", "jax"])
def test_ivf_index_cross_loads_under_pq_knob(tmp_path, monkeypatch, built_by):
    """An `ivf` index built by either package searches in the other under
    LEANN_IVF_ENGINE=pq: each passage's own vector returns it first."""
    from leann_tpu.index.builder import IndexBuilder as JaxIndexBuilder
    from leann_tpu.index.searcher import IndexSearcher as JaxSearcher
    from leann_tpu_torch.embed.fake import FakeEmbedding
    from leann_tpu_torch.index import IndexBuilder, IndexSearcher

    texts = [f"passage {i} about topic {i % 7}" for i in range(300)]
    vecs = FakeEmbedding(32).embed(texts)
    base = str(tmp_path / built_by / "documents.leann")
    if built_by == "torch":
        b = IndexBuilder(base, dim=32, backend="ivf", device="cpu")
    else:
        b = JaxIndexBuilder(base, dim=32, backend="ivf")
    for i, (t, v) in enumerate(zip(texts, vecs)):
        b.add(f"d{i}", t, v)
    b.build()
    monkeypatch.setenv("LEANN_IVF_ENGINE", "pq")
    if built_by == "torch":
        searcher = JaxSearcher.load(base)
    else:
        searcher = IndexSearcher.load(base, device="cpu")
    assert type(searcher.backend.engine).__name__ == "IvfPqEngine"
    res = searcher.search(vecs[:20])
    assert [r[0].id for r in res] == [f"d{i}" for i in range(20)]
