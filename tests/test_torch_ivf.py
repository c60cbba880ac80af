"""Parity of the port's bf16 IVF engine (`leann_tpu_torch/ops/ivf.py`,
`ops/bucket_kernels.py`: kernel B4's plain version) and the `ivf`
backend with the JAX reference (`leann_tpu/ops/ivf.py`,
`ops/pallas_kernels.py` in interpret mode), both on the CPU.

Tolerances:
- k-means on well-separated clusters: assignments equal, centers within
  1e-5 (both draw the same initial centers; sums differ in order only);
- `pack_buckets`: byte-equal;
- bucket dots: within 1e-5 x |q| x (largest row norm) per score (the
  products are exact in float32, the sums run in another order);
- engine searches: ids equal row for row wherever the reference's 10th and
  11th exact scores differ by more than 1e-4, scores within rtol 1e-5
  (atol 1e-4 for scores near zero); calibrated nprobe equal;
- indexes built by either package: the same calibrated nprobe in the
  meta, and each package's search of the other's index returns the
  top-10 of the package that built it (overlap >= 0.95; queries are
  corpus rows, which come back first)."""

import numpy as np
import pytest
import torch

from leann_tpu.ops import ivf as jivf
from leann_tpu.ops.distance import exact_topk as jexact_topk
from leann_tpu_torch.ops import bucket_kernels as tbk
from leann_tpu_torch.ops import ivf as tivf

torch.set_num_threads(1)


def clustered(n, d, k, seed, spread=4.0):
    rng = np.random.default_rng(seed)
    centers = spread * rng.standard_normal((k, d)).astype(np.float32)
    x = centers[rng.integers(0, k, n)] + rng.standard_normal(
        (n, d)).astype(np.float32)
    return np.ascontiguousarray(x, np.float32)


def separable_rows(q, x, metric, k=10):
    """Rows whose reference exact 10th and 11th scores differ by > 1e-4
    (no tie decides the top-10 there)."""
    sc, _ = jexact_topk(q, x, k + 1, metric=metric)
    sc = np.asarray(sc)
    return np.abs(sc[:, k - 1] - sc[:, k]) > 1e-4


def assert_search_equal(got, ref, rows):
    gi, gs = (np.asarray(a) for a in got)
    ri, rs = (np.asarray(a) for a in ref)
    assert gi.shape == ri.shape
    assert rows.mean() >= 0.5, "the test data must separate most rows"
    np.testing.assert_array_equal(gi[rows], ri[rows])
    np.testing.assert_allclose(gs[rows], rs[rows], rtol=1e-5, atol=1e-4)
    for a, b in zip(gi, ri):
        assert len(set(a.tolist()) & set(b.tolist())) >= 9


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_kmeans_matches_reference(metric):
    x = clustered(3000, 32, 24, seed=0, spread=6.0)
    jc, ja = jivf.kmeans(x, 24, iters=6, metric=metric, seed=3)
    tc, ta = tivf.kmeans(x, 24, iters=6, metric=metric, seed=3, device="cpu")
    assert tc.dtype == np.float32 and ta.dtype == np.int32
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cap", [None, 40])
def test_pack_buckets_byte_equal(cap):
    x = clustered(900, 16, 8, seed=1)
    centers, assign = jivf.kmeans(x, 8, iters=3, metric="l2", seed=0)
    centers, assign = np.asarray(centers), np.asarray(assign)
    for a, b in zip(tivf.pack_buckets(x, assign, centers, cap),
                    jivf.pack_buckets(x, assign, centers, cap)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("k,cap,d,b,p", [
    (8, 128, 128, 16, 3),     # the shapes of tests/test_pallas.py
    (6, 128, 96, 8, 4),       # 96-d rows
    (5, 256, 768, 8, 2),      # 768-d rows
])
def test_bucket_dots_plain_matches_pallas(k, cap, d, b, p):
    import jax.numpy as jnp

    from leann_tpu.ops.pallas_kernels import ivf_bucket_dots

    rng = np.random.default_rng(k + d)
    vecs = rng.standard_normal((k, cap, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    probe = rng.integers(0, k, (b, p)).astype(np.int32)
    probe[0, :] = probe[0, 0]                 # one bucket probed repeatedly
    vb = jnp.asarray(vecs).astype(jnp.bfloat16)
    ref = np.asarray(ivf_bucket_dots(jnp.asarray(q), jnp.asarray(probe), vb,
                                     interpret=True))
    tvecs = torch.from_numpy(vecs).to(torch.bfloat16)
    got = tbk.ivf_bucket_dots(torch.from_numpy(q), torch.from_numpy(probe),
                              tvecs)
    assert got.shape == (p, b, cap) and got.dtype == torch.float32
    tol = 1e-5 * np.linalg.norm(q, axis=1).max() * float(
        torch.linalg.vector_norm(tvecs.float(), dim=2).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_engine_search_matches_reference(metric):
    """IvfEngine.search (torch scan) and search_pallas (kernel B4's path)
    against the reference's search and its Pallas path in interpret
    mode, on the same centers (the reference's k-means)."""
    x = clustered(1200, 128, 16, seed=2)
    ref = jivf.IvfEngine(x, n_clusters=16, metric=metric, cap=64)
    eng = tivf.IvfEngine(x, n_clusters=16, metric=metric, cap=64,
                         centers=np.asarray(ref.centers),
                         assign=np.asarray(ref.assign), device="cpu")
    assert eng.cap == ref.cap
    rng = np.random.default_rng(3)
    q = x[rng.integers(0, len(x), 12)] + 0.05 * rng.standard_normal(
        (12, 128)).astype(np.float32)
    xm = x / np.linalg.norm(x, axis=1, keepdims=True) if metric == "cosine" else x
    qm = q / np.linalg.norm(q, axis=1, keepdims=True) if metric == "cosine" else q
    rows = separable_rows(qm, xm, "ip" if metric == "cosine" else metric)
    assert_search_equal(eng.search(q, k=10, nprobe=8),
                        ref.search(q, k=10, nprobe=8), rows)
    launches = tbk.ivf_bucket_dots.launches
    assert_search_equal(eng.search_pallas(q, k=10, nprobe=8),
                        ref.search_pallas(q, k=10, nprobe=8, interpret=True),
                        rows)
    assert tbk.ivf_bucket_dots.launches == launches   # CPU: the plain version


def test_ivf_search_pallas_odd_batch_and_empty_slots():
    """Any B (the reference needs B % 8 == 0), and sentinel slots that
    never come back: a tiny corpus whose buckets are mostly empty."""
    x = clustered(90, 24, 4, seed=4)
    eng = tivf.IvfEngine(x, n_clusters=6, metric="l2", cap=32, device="cpu")
    q = x[:5] + 0.01
    ids, scores = eng.search_pallas(q, k=40, nprobe=2)
    i2, s2 = eng.search(q, k=40, nprobe=2)
    np.testing.assert_array_equal(ids, i2)
    np.testing.assert_allclose(scores, s2, rtol=1e-6)
    assert (ids[:, 0] == np.arange(5)).all()
    assert ((ids == -1) == ~np.isfinite(scores)).all()
    assert ((ids >= 0) | (ids == -1)).all() and (ids < len(x)).all()


def test_ivf_no_vector_dropped_by_overflow():
    """cap below the largest cluster: overflow buckets keep every vector
    findable, as in the reference."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((500, 8)).astype(np.float32) * 0.01
    eng = tivf.IvfEngine(x, n_clusters=4, metric="l2", cap=32, device="cpu")
    ref = jivf.IvfEngine(x, n_clusters=4, metric="l2", cap=32)
    assert eng.bucket_cent.shape[0] == ref.bucket_cent.shape[0] > 4
    for i in (0, 123, 499):
        idx, _ = eng.search(x[i], k=1, nprobe=eng.bucket_cent.shape[0])
        assert idx[0, 0] == i
        idx, _ = eng.search_pallas(x[i], k=1,
                                   nprobe=eng.bucket_cent.shape[0])
        assert idx[0, 0] == i


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_ivf_search_many_device_matches_single(metric):
    """[M, B, D] batches give the reference's search_many_device on the
    same tables (the queries go in as they are, so cosine scores carry
    |q|), and for l2 also search_device's results batch by batch."""
    import jax.numpy as jnp

    x = clustered(3000, 32, 40, seed=13)
    ref = jivf.IvfEngine(x, n_clusters=64, metric=metric)
    eng = tivf.IvfEngine(x, metric=metric, centers=np.asarray(ref.centers),
                         assign=np.asarray(ref.assign), device="cpu")
    rng = np.random.default_rng(14)
    qs = 2.0 * x[rng.integers(0, 3000, (3, 8))] + np.float32(0.01)
    ids_m, sc_m = eng.search_many_device(torch.from_numpy(qs), k=10,
                                         nprobe=16)
    assert ids_m.shape == (3, 8, 10)
    want = ref.search_many_device(jnp.asarray(qs), k=10, nprobe=16)
    for m in range(3):
        rows = separable_rows(qs[m], x, metric)
        assert_search_equal((ids_m[m].numpy(), sc_m[m].numpy()),
                            (np.asarray(want[0][m]), np.asarray(want[1][m])),
                            rows)
        if metric != "cosine":
            ids_1, sc_1 = eng.search_device(torch.from_numpy(qs[m]), k=10,
                                            nprobe=16)
            assert torch.equal(ids_m[m], ids_1)
            assert torch.equal(sc_m[m], sc_1)
    if metric == "cosine":
        assert float(sc_m.max()) > 1.5


def test_calibrate_nprobe_matches_reference():
    rng = np.random.default_rng(3)
    n, d, n_true = 4000, 32, 1000   # many tiny true clusters
    centers = rng.standard_normal((n_true, d)).astype(np.float32) * 4
    x = (centers[rng.integers(0, n_true, n)]
         + rng.standard_normal((n, d)).astype(np.float32))
    ref = jivf.IvfEngine(x, metric="l2")
    eng = tivf.IvfEngine(x, metric="l2", centers=np.asarray(ref.centers),
                         assign=np.asarray(ref.assign), device="cpu")
    got = eng.calibrate_nprobe(target_recall=0.95, sample=64)
    want = ref.calibrate_nprobe(target_recall=0.95, sample=64)
    assert got[0] == want[0]
    assert abs(got[1] - want[1]) <= 0.02


def _build(builder_cls, base, x, **kw):
    b = builder_cls(base, dim=x.shape[1], backend="ivf", metric="l2", **kw)
    for i, v in enumerate(x):
        b.add(f"d{i}", f"passage {i}", v)
    return b.build()


def test_ivf_index_cross_load_both_ways(tmp_path):
    """An `ivf` index built by either package searches in the other: the
    meta's calibrated nprobe is equal, and each searcher returns the
    results of the package that built it."""
    from leann_tpu.index import IndexSearcher as JaxSearcher
    from leann_tpu.index import SearchOptions as JaxOptions
    from leann_tpu.index.builder import IndexBuilder as JaxBuilder
    from leann_tpu_torch.index import IndexBuilder, IndexSearcher, SearchOptions

    x = clustered(1200, 32, 90, seed=5, spread=3.0)
    jbase = str(tmp_path / "jax" / "documents.leann")
    tbase = str(tmp_path / "torch" / "documents.leann")
    jmeta = _build(JaxBuilder, jbase, x)
    tmeta = _build(IndexBuilder, tbase, x, device="cpu")
    assert jmeta.backend_kwargs["nprobe"] == tmeta.backend_kwargs["nprobe"]
    assert jmeta.backend_kwargs["n_clusters"] == tmeta.backend_kwargs["n_clusters"]

    q = x[::37]
    want = [f"d{i}" for i in range(0, len(x), 37)]

    def ids(res):
        return [[r.id for r in row] for row in res]

    for base in (jbase, tbase):
        mine = ids(IndexSearcher.load(base, device="cpu").search(
            q, SearchOptions(top_k=10)))
        theirs = ids(JaxSearcher.load(base).search(q, JaxOptions(top_k=10)))
        assert [row[0] for row in mine] == want
        assert np.mean([len(set(a) & set(b)) / 10
                        for a, b in zip(mine, theirs)]) >= 0.95


def test_ivf_searcher_honours_the_calibrated_floor():
    from leann_tpu_torch.backend import IvfSearcher
    from leann_tpu_torch.store.ivffile import IvfFile

    x = clustered(2000, 16, 30, seed=6)
    eng = tivf.IvfEngine(x, metric="l2", device="cpu")
    s = IvfSearcher(x, IvfFile(eng.centers, eng.assign, "l2"), metric="l2",
                    default_nprobe=12, device="cpu")
    q = x[:4] + 0.01
    got = s.search(q, k=10, complexity=16)          # 16 // 2 = 8 < floor
    want = eng.search(q, k=10, nprobe=12)
    np.testing.assert_array_equal(got[0], want[0])
    got = s.search(q, k=10, complexity=64)          # 32 > floor
    np.testing.assert_array_equal(got[0], eng.search(q, k=10, nprobe=32)[0])
