"""Parity of the port's exact search (`leann_tpu_torch/ops/distance.py`)
with the JAX reference (`leann_tpu/ops/distance.py`), on CPU.

Same numpy inputs through both packages. Tolerances: ids equal (the
random gaussian corpora have no exact score ties); scores rtol 1e-5
(float32 summation order differs between XLA and PyTorch)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from leann_tpu.ops import distance as jd
from leann_tpu_torch.ops import distance as td

# the suite runs in several worker processes that share the CPUs: one
# intra-op thread each keeps PyTorch's many small ops from oversubscribing
torch.set_num_threads(1)


def _data(n=3000, d=32, b=24, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((20, d)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 20, n)]
         + rng.standard_normal((n, d)).astype(np.float32))
    q = x[rng.integers(0, n, b)] + 0.1 * rng.standard_normal((b, d)).astype(
        np.float32)
    return x.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("two_stage", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_exact_topk_matches_reference(metric, two_stage):
    # chunk 1024 over n=3000 exercises the padded last chunk (pad bias)
    x, q = _data()
    js, ji = jd.exact_topk(q, x, 10, metric=metric, chunk_size=1024,
                           two_stage=two_stage)
    ts, ti = td.exact_topk(q, x, 10, metric=metric, chunk_size=1024,
                           two_stage=two_stage, device="cpu")
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_exact_engine_matches_reference(metric):
    x, q = _data(n=2500, seed=1)
    je = jd.ExactEngine(x, metric=metric, chunk_size=1024)
    te = td.ExactEngine(x, metric=metric, chunk_size=1024, device="cpu")
    for exact_scan in (False, True):
        ji, js = je.search(q, k=10, exact_scan=exact_scan)
        ti, ts = te.search(q, k=10, exact_scan=exact_scan)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_make_bias_matches_reference(metric):
    x, _ = _data(n=100, seed=2)
    pad = np.concatenate([x, np.zeros((28, x.shape[1]), np.float32)])
    jb = np.asarray(jd.make_bias(100, 128, metric, jnp.asarray(pad)))
    tb = td.make_bias(100, 128, metric, torch.from_numpy(pad)).numpy()
    np.testing.assert_allclose(tb, jb, rtol=1e-6)
    assert (tb[100:] == -1e30).all()


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_pairwise_scores_matches_reference(metric):
    x, q = _data(n=200, seed=3)
    js = np.asarray(jd.pairwise_scores(jnp.asarray(q), jnp.asarray(x), metric))
    ts = td.pairwise_scores(torch.from_numpy(q), torch.from_numpy(x),
                            metric).numpy()
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-4)


def test_search_many_device_matches_search_device():
    x, q = _data(n=1500, b=16, seed=4)
    te = td.ExactEngine(x, metric="l2", device="cpu")
    qs = torch.from_numpy(q.reshape(2, 8, -1))
    ids_m, sc_m = te.search_many_device(qs, k=10)
    assert ids_m.shape == (2, 8, 10)
    for m in range(2):
        ids_1, sc_1 = te.search_device(qs[m], k=10)
        assert torch.equal(ids_m[m], ids_1)
        assert torch.equal(sc_m[m], sc_1)


def test_topk_stable_keeps_lower_index_on_ties():
    sc = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, pos = td.topk_stable(sc, 3)
    assert pos.tolist() == [[1, 2, 4]]
    assert vals.tolist() == [[3.0, 3.0, 3.0]]
