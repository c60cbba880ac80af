"""Parity of the port's residual-int8 IVF engine
(`leann_tpu_torch/ops/ivf_int8.py`, with kernel B2's plain version in
`ops/bucket_kernels.py`) with the JAX reference (`leann_tpu/ops/
ivf_int8.py`, `ops/pallas_kernels.py` in interpret mode), on the CPU.

Tolerances:
- `pack_int8_buckets`: byte-equal;
- bucket scores: -inf positions equal exactly; finite scores within
  1e-5 x |q| x (largest |c| + scale * |r8| of the bucket rows), for l2
  twice that (the int8 x bf16 products are exact in float32, the sums run
  in another order);
- engine searches with LEANN_IVF8_PALLAS unset and set to 1: ids equal
  row for row wherever the reference's 10th and 11th exact scores differ
  by more than 1e-4, scores within rtol 1e-5 (atol 1e-4 near zero);
  calibrated nprobe equal."""

import numpy as np
import pytest
import torch

from leann_tpu.ops import ivf_int8 as jiv8
from leann_tpu.ops.distance import exact_topk as jexact_topk
from leann_tpu_torch.ops import bucket_kernels as tbk
from leann_tpu_torch.ops import ivf_int8 as tiv8

torch.set_num_threads(1)


def clustered(n=3000, d=32, k=24, seed=0):
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.standard_normal((k, d)).astype(np.float32)
    x = centers[rng.integers(0, k, n)] + rng.standard_normal(
        (n, d)).astype(np.float32)
    return np.ascontiguousarray(x, np.float32)


@pytest.mark.parametrize("cap", [None, 50])
def test_pack_int8_buckets_byte_equal(cap):
    from leann_tpu.ops.ivf import kmeans

    x = clustered(n=700, d=24, k=8, seed=4)
    centers, assign = (np.asarray(a) for a in kmeans(x, 8, iters=4,
                                                     metric="l2", seed=0))
    for a, b in zip(tiv8.pack_int8_buckets(x, assign, centers, cap),
                    jiv8.pack_int8_buckets(x, assign, centers, cap)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _tables(ref):
    """The reference's padded kernel tables (cap to 32, D to 128, ids -1)
    as numpy."""
    pay, sc, ns, ids, cent, cap_pad, d_pad = ref._pallas_tables()
    return [np.asarray(t) for t in (pay, sc, ns, ids, cent)], cap_pad, d_pad


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_bucket_scores_plain_matches_pallas(metric):
    """ivf8_bucket_scores_plain on the reference's padded tables against
    the Pallas kernel in interpret mode: an odd batch, a probe list that
    repeats one bucket, and buckets with empty (-1) slots."""
    import jax.numpy as jnp

    from leann_tpu.ops.pallas_kernels import ivf8_bucket_scores

    x = clustered(n=900, d=40, k=12, seed=1)
    ref = jiv8.IvfInt8Engine(x, n_clusters=12, metric=metric, seed=0)
    (pay, sc, ns, ids, cent), cap_pad, d_pad = _tables(ref)
    rng = np.random.default_rng(2)
    b, p = 5, 4
    q = np.zeros((b, d_pad), np.float32)
    q[:, :40] = x[rng.integers(0, len(x), b)] + 0.1
    probe = rng.integers(0, pay.shape[0], (b, p)).astype(np.int32)
    probe[1, :] = probe[1, 0]
    want = np.asarray(ivf8_bucket_scores(
        jnp.asarray(q), jnp.asarray(probe), *(jnp.asarray(t) for t in
                                              (pay, sc, ns, ids, cent)),
        metric=metric, interpret=True))
    got = tbk.ivf8_bucket_scores(
        torch.from_numpy(q), torch.from_numpy(probe),
        *(torch.from_numpy(t) for t in (pay, sc, ns, ids, cent)), metric)
    assert got.shape == (b, p, cap_pad)
    got = got.numpy()
    assert (ids == -1).any()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isfinite(got[~np.isneginf(got)]).all()
    row = (np.linalg.norm(cent, axis=1)[:, None]
           + sc * np.linalg.norm(pay.astype(np.float32), axis=2)).max()
    tol = 1e-5 * np.linalg.norm(q, axis=1).max() * row
    tol *= 2 if metric == "l2" else 1
    live = np.isfinite(want)
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=tol)


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


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_engine_search_matches_reference(monkeypatch, metric, pallas):
    """IvfInt8Engine.search with LEANN_IVF8_PALLAS unset (the torch scan)
    and set to 1 (kernel B2's path) against the reference's scan and its
    Pallas path in interpret mode, on the same centers."""
    x = clustered(seed=3)
    ref = jiv8.IvfInt8Engine(x, n_clusters=24, metric=metric, seed=0)
    eng = tiv8.IvfInt8Engine(x, metric=metric, centers=np.asarray(ref.centers),
                             assign=np.asarray(ref.assign), device="cpu")
    rng = np.random.default_rng(4)
    q = x[rng.integers(0, len(x), 9)] + 0.05 * rng.standard_normal(
        (9, 32)).astype(np.float32)
    if pallas:
        import jax.numpy as jnp

        pay, sc, ns, ids, cent, cap_pad, d_pad = ref._pallas_tables()
        want = jiv8._ivf8_search_pallas_jit(
            jnp.asarray(q), ref.bucket_cent, pay, sc, ns, ids, cent, k=10,
            c=40, nprobe=8, metric=metric, cap_pad=cap_pad, d_pad=d_pad,
            interpret=True)
        monkeypatch.setenv("LEANN_IVF8_PALLAS", "1")
    else:
        monkeypatch.delenv("LEANN_IVF8_PALLAS", raising=False)
        want = ref.search(q, k=10, nprobe=8, rescore_factor=4)
    launches = tbk.ivf8_bucket_scores.launches
    got = eng.search(q, k=10, nprobe=8, rescore_factor=4)
    assert tbk.ivf8_bucket_scores.launches == launches   # CPU: plain version
    _assert_equal(got, want, _separable(q, x, metric))


def test_kernel_path_equals_scan_on_padded_and_unpadded_tables(monkeypatch):
    """_ivf8_search_pallas_impl on the reference's padded tables (cap to
    32, D to 128) returns what it returns on the port's unpadded ones,
    and what the torch scan returns."""
    x = clustered(n=1500, d=40, k=16, seed=5)
    ref = jiv8.IvfInt8Engine(x, n_clusters=16, metric="l2", seed=0)
    eng = tiv8.IvfInt8Engine(x, metric="l2", centers=np.asarray(ref.centers),
                             assign=np.asarray(ref.assign), device="cpu")
    q = torch.from_numpy(x[:6] + np.float32(0.02))
    (pay, sc, ns, ids, cent), cap_pad, d_pad = _tables(ref)
    padded = tiv8._ivf8_search_pallas_impl(
        q, eng.bucket_cent, *(torch.from_numpy(t) for t in
                              (pay, sc, ns, ids, cent)),
        k=10, c=40, nprobe=6, metric="l2", cap_pad=cap_pad, d_pad=d_pad)
    monkeypatch.setenv("LEANN_IVF8_PALLAS", "1")
    unpadded = eng.search_device(q, k=10, nprobe=6)
    monkeypatch.delenv("LEANN_IVF8_PALLAS")
    scan = eng.search_device(q, k=10, nprobe=6)
    for a, b in ((padded, unpadded), (unpadded, scan)):
        assert torch.equal(a[0], b[0])
        torch.testing.assert_close(a[1], b[1], rtol=1e-6, atol=1e-5)
    assert (unpadded[0][:, 0] == torch.arange(6)).all()


def test_ivf8_no_vector_dropped_by_overflow(monkeypatch):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((400, 16)).astype(np.float32) * 0.01
    eng = tiv8.IvfInt8Engine(x, n_clusters=4, metric="l2", cap=32,
                             device="cpu")
    ref = jiv8.IvfInt8Engine(x, n_clusters=4, metric="l2", cap=32)
    assert eng.bucket_cent.shape[0] == ref.bucket_cent.shape[0] > 4
    kp = eng.bucket_cent.shape[0]
    for flag in ("0", "1"):
        monkeypatch.setenv("LEANN_IVF8_PALLAS", flag)
        for i in (0, 201, 399):
            idx, _ = eng.search(x[i], k=1, nprobe=kp)
            assert idx[0, 0] == i


@pytest.mark.parametrize("flag", ["0", "1"])
def test_ivf8_search_many_device_matches_single(monkeypatch, flag):
    monkeypatch.setenv("LEANN_IVF8_PALLAS", flag)
    x = clustered(n=2000, d=32, k=16, seed=5)
    eng = tiv8.IvfInt8Engine(x, n_clusters=16, metric="l2", device="cpu")
    qs = torch.from_numpy(x[np.random.default_rng(6).integers(
        0, len(x), (2, 7))])
    ids_m, sc_m = eng.search_many_device(qs, k=5, nprobe=8)
    assert ids_m.shape == (2, 7, 5)
    for m in range(2):
        ids_1, sc_1 = eng.search_device(qs[m], k=5, nprobe=8)
        assert torch.equal(ids_m[m], ids_1) and torch.equal(sc_m[m], sc_1)


def test_ivf8_calibrate_nprobe_matches_reference():
    x = clustered(n=4000, d=32, k=32, seed=7)
    ref = jiv8.IvfInt8Engine(x, n_clusters=32, metric="l2", seed=0)
    eng = tiv8.IvfInt8Engine(x, metric="l2", centers=np.asarray(ref.centers),
                             assign=np.asarray(ref.assign), device="cpu")
    got = eng.calibrate_nprobe(target_recall=0.9, sample=64)
    want = ref.calibrate_nprobe(target_recall=0.9, sample=64)
    assert got[0] == want[0] and abs(got[1] - want[1]) <= 0.02
    assert got[1] >= 0.9
