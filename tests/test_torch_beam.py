"""Parity of the port's beam search (`leann_tpu_torch/ops/beam.py`) with
the JAX reference (`leann_tpu/ops/beam.py`), on CPU.

Same numpy graphs and queries through both packages. Tolerances are
stated per test: ids/rows equal where the algorithms are deterministic,
top-10 overlap >= 0.99 where a hashed visited table or float ties can
route a query differently, and scores rtol 1e-5 (float32 summation
order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from leann_tpu.ops import beam as jb
from leann_tpu.ops.distance import exact_topk
from leann_tpu_torch.ops import beam as tb

# the suite runs in several worker processes that share the CPUs: one
# intra-op thread each keeps PyTorch's many small ops from oversubscribing
torch.set_num_threads(1)


def _knn_graph(x, r):
    _, nn = exact_topk(x, x, r + 1, metric="l2")
    return np.asarray([[j for j in row.tolist() if j != i][:r]
                       for i, row in enumerate(nn)], dtype=np.int32)


def _clustered(n, d, seed, clusters=20):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((clusters, d)).astype(np.float32) * 3
    return (c[rng.integers(0, clusters, n)]
            + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def _overlap(a, b):
    return np.mean([len(set(x.tolist()) & set(y.tolist())) / len(x)
                    for x, y in zip(np.asarray(a), np.asarray(b))])


def test_hash_slot_matches_reference_near_2_31():
    ids = np.concatenate([
        np.arange(2**31 - 300, 2**31 - 1, dtype=np.int64),
        np.array([0, 1, 7, 12345, 2**30, -1, -5], np.int64),
        np.random.default_rng(0).integers(0, 2**31 - 1, 500),
    ]).astype(np.int32)
    for bits in (8, 12, 16):
        want = np.asarray(jb._hash_slot(jnp.asarray(ids), bits))
        got = tb._hash_slot(torch.from_numpy(ids), bits).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0 and got.max() < 2**bits


@pytest.mark.parametrize("expansions,track", [(1, 0), (2, 48)])
def test_beam_search_batch_matches_reference(expansions, track):
    """Row-gather search on an exact kNN graph: beam ids equal on >= 99%
    of positions, vlog equal on >= 99%, scores rtol 1e-5."""
    rng = np.random.default_rng(1)
    n, d, r = 800, 16, 12
    x = rng.standard_normal((n, d)).astype(np.float32)
    adj = np.concatenate([_knn_graph(x, r), np.full((1, r), n, np.int32)])
    x1 = np.concatenate([x, np.zeros((1, d), np.float32)])
    nsq = (x1 * x1).sum(1)
    q = rng.standard_normal((16, d)).astype(np.float32)
    exc = np.full(16, -1, np.int32)
    exc[:4] = [3, 5, 7, 9]
    kw = dict(beam_width=32, max_iters=80, metric="l2",
              expansions=expansions, track_visited=track)
    jo = jb.beam_search_batch(
        jnp.asarray(q), jnp.asarray(x1), jnp.asarray(adj), jnp.asarray(nsq),
        jnp.int32(0), jnp.asarray(exc), **kw)
    to = tb.beam_search_batch(
        torch.from_numpy(q), torch.from_numpy(x1), torch.from_numpy(adj),
        torch.from_numpy(nsq), 0, torch.from_numpy(exc), **kw)
    assert (to[0].numpy() == np.asarray(jo[0])).mean() >= 0.99
    np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), rtol=1e-5,
                               atol=1e-4)
    if track:
        assert (to[2].numpy() == np.asarray(jo[2])).mean() >= 0.99


@pytest.mark.parametrize("mode", ["int8", "bf16", "none"])
def test_beam_engine_matches_reference(mode):
    """BeamSearchEngine in each layout: top-10 overlap >= 0.99 with the
    reference engine, and rescored scores rtol 1e-5 where ids agree."""
    x = _clustered(1200, 24, seed=7)
    rng = np.random.default_rng(2)
    adj = _knn_graph(x, 12)
    q = x[rng.integers(0, len(x), 24)] + 0.05 * rng.standard_normal(
        (24, 24)).astype(np.float32)
    je = jb.BeamSearchEngine(x, adj, medoid=0, metric="l2", block_mode=mode)
    te = tb.BeamSearchEngine(x, adj, medoid=0, metric="l2", block_mode=mode,
                             device="cpu")
    assert te.block_mode == je.block_mode == mode
    np.testing.assert_array_equal(te.seed_ids.numpy(), np.asarray(je.seed_ids))
    ji, js = je.search(q, k=10, beam_width=32)
    ti, ts = te.search(q, k=10, beam_width=32)
    assert _overlap(ti, ji) >= 0.99
    same = ti == ji
    np.testing.assert_allclose(ts[same], js[same], rtol=1e-5, atol=1e-4)


def test_build_inline_blocks_matches_reference():
    x = _clustered(300, 32, seed=3)
    x1 = np.concatenate([x, np.zeros((1, 32), np.float32)])
    adj = np.random.default_rng(0).integers(0, 300, (301, 8)).astype(np.int32)
    adj[300] = 300
    for dtype in ("int8", "bf16"):
        jbk, jsc, jns = jb.build_inline_blocks(
            jnp.asarray(x1), jnp.asarray(adj), dtype=dtype, chunk=128)
        tbk, tsc, tns = tb.build_inline_blocks(
            torch.from_numpy(x1), torch.from_numpy(adj), dtype=dtype, chunk=128)
        if dtype == "int8":
            np.testing.assert_array_equal(tbk.numpy(), np.asarray(jbk))
            np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-6)
        else:
            np.testing.assert_array_equal(
                tbk.float().numpy(), np.asarray(jbk.astype(jnp.float32)))
            assert tsc is None and jsc is None
        np.testing.assert_allclose(tns.numpy(), np.asarray(jns), rtol=1e-5)


def test_merge_visited_matches_reference():
    rng = np.random.default_rng(4)
    n = 50
    beam = rng.integers(0, n + 1, (6, 8)).astype(np.int32)
    vlog = rng.integers(0, n + 1, (6, 8)).astype(np.int32)
    vlog[:, :3] = beam[:, :3]                       # duplicates
    score = rng.standard_normal(n + 1).astype(np.float32)
    bs, vs = score[beam], score[vlog]
    ji, js = jb._merge_visited(jnp.asarray(beam), jnp.asarray(bs),
                               jnp.asarray(vlog), jnp.asarray(vs), n)
    ti, ts = tb._merge_visited(torch.from_numpy(beam).long(),
                               torch.from_numpy(bs),
                               torch.from_numpy(vlog).long(),
                               torch.from_numpy(vs), n)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_seed_pool_policy_matches_reference(monkeypatch):
    for n in (100, 100_000, 4_000_000):
        assert tb.seed_pool_size(n) == jb.seed_pool_size(n)
    monkeypatch.setenv("LEANN_SEED_POOL", "512")
    assert tb.seed_pool_size(100_000) == 512


def test_search_many_device_matches_single():
    x = _clustered(1000, 16, seed=5)
    te = tb.BeamSearchEngine(x, _knn_graph(x, 8), medoid=0, metric="l2",
                             block_mode="none", device="cpu")
    rng = np.random.default_rng(6)
    qs = torch.from_numpy(x[rng.integers(0, 1000, (2, 8))] + np.float32(0.01))
    ids_m, sc_m = te.search_many_device(qs, k=10, beam_width=32)
    assert ids_m.shape == (2, 8, 10)
    for m in range(2):
        ids_1, sc_1 = te.search_beam(qs[m].numpy(), beam_width=32)
        assert torch.equal(ids_m[m], ids_1[:, :10])
        torch.testing.assert_close(sc_m[m], sc_1[:, :10])
