"""Parity of the port's product quantization (`leann_tpu_torch/ops/pq.py`)
with the JAX reference (`leann_tpu/ops/pq.py`), both on the CPU.

Tolerances: codebooks within atol 1e-4 on samples whose k-means
assignments have no near-ties (discrete, well-separated subspace
structure; both packages draw the same initial centroids, so they walk
the same Lloyd path and differ only in float32 summation order); codes
equal on >= 99.5% of entries (argmax near-ties may flip); the host-side
numpy functions (`reconstruct_pq`, `quantize_norms`, `adc_affine`)
exactly."""

import numpy as np
import pytest
import torch

from leann_tpu.ops import pq as jq
from leann_tpu_torch.ops import pq as tq

torch.set_num_threads(1)


def _separated(n, d, m, ksub, seed, scale=4.0):
    """Each of m subspaces takes one of ksub fixed sub-vectors: a sample
    whose k-means assignments are unambiguous."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((m, ksub, d // m)).astype(np.float32) * scale
    pick = rng.integers(0, ksub, (n, m))
    return cents[np.arange(m)[None], pick].reshape(n, d).astype(np.float32)


def _gauss(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def test_train_pq_matches_reference():
    x = _separated(2048, 32, 4, 16, 0)
    jb = jq.train_pq(x, m=4, ksub=16, iters=6)
    tb = tq.train_pq(x, m=4, ksub=16, iters=6, device="cpu")
    assert tb.shape == (4, 16, 8) and tb.dtype == np.float32
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-4)


@pytest.mark.parametrize("ksub", [16, 256])
def test_encode_pq_matches_reference(ksub):
    books = jq.train_pq(_gauss(1024, 32, 1), m=8, ksub=ksub, iters=3)
    y = _gauss(3000, 32, 2)
    jc = jq.encode_pq(y, books)
    tc = tq.encode_pq(y, books, chunk=1000, device="cpu")
    assert tc.dtype == np.uint8 and tc.shape == (3000, 8)
    assert (tc == jc).mean() >= 0.995
    np.testing.assert_array_equal(tq.reconstruct_pq(jc, books),
                                  jq.reconstruct_pq(jc, books))


def test_adc_lut_matches_reference():
    books = jq.train_pq(_gauss(512, 32, 3), m=4, ksub=16, iters=3)
    q = _gauss(6, 32, 4)
    want = np.asarray(jq.adc_lut(q, books))
    got = tq.adc_lut(torch.from_numpy(q), torch.from_numpy(books)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_residual_pq_matches_reference():
    x = (_separated(2048, 32, 2, 4, 0, 8.0)
         + _separated(2048, 32, 4, 16, 10, 0.5))
    jbc, jbf = jq.train_residual_pq(x, mc=2, mf=4, ksub=16, iters=5)
    tbc, tbf = tq.train_residual_pq(x, mc=2, mf=4, ksub=16, iters=5,
                                    device="cpu")
    np.testing.assert_allclose(tbc, jbc, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tbf, jbf, rtol=0, atol=1e-4)
    y = _gauss(2000, 32, 5)
    jcodes, jnsq = jq.encode_residual_pq(y, jbc, jbf)
    tcodes, tnsq = tq.encode_residual_pq(y, jbc, jbf, chunk=700, device="cpu")
    assert (tcodes == jcodes).mean() >= 0.995
    same = (tcodes == jcodes).all(1)
    np.testing.assert_array_equal(tnsq[same], jnsq[same])
    np.testing.assert_array_equal(
        tq.reconstruct_residual_pq(jcodes, jbc, jbf),
        jq.reconstruct_residual_pq(jcodes, jbc, jbf))


def test_quantize_norms_and_adc_affine_exact():
    rng = np.random.default_rng(6)
    nsq = (rng.random(500) * 40 + 3).astype(np.float32)
    for a, b in zip(tq.quantize_norms(nsq), jq.quantize_norms(nsq)):
        np.testing.assert_array_equal(a, b)
    books_c = rng.standard_normal((2, 256, 16)).astype(np.float32)
    books_f = rng.standard_normal((4, 256, 8)).astype(np.float32)
    _, off, scale = jq.quantize_norms(nsq)
    for metric in ("l2", "ip"):
        for bc in (None, books_c):
            w1, b1 = tq.adc_affine(32, metric, bc, books_f, 256, off, scale)
            w2, b2 = jq.adc_affine(32, metric, bc, books_f, 256, off, scale)
            np.testing.assert_array_equal(w1, w2)
            np.testing.assert_array_equal(b1, b2)


def test_train_opq_matches_reference():
    x = _separated(2048, 32, 4, 16, 6)
    jr, jb = jq.train_opq(x, m=4, ksub=16, iters=6, opq_iters=2)
    tr, tb = tq.train_opq(x, m=4, ksub=16, iters=6, opq_iters=2,
                          device="cpu")
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tr @ tr.T, np.eye(32), atol=1e-5)


def test_encode_rejects_wide_codebooks():
    with pytest.raises(ValueError):
        tq.encode_pq(_gauss(4, 8, 0), np.zeros((2, 300, 4), np.float32),
                     device="cpu")
    with pytest.raises(ValueError):
        tq.train_pq(_gauss(64, 30, 0), m=4, ksub=8, device="cpu")
