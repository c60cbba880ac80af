"""Parity of the port's fused traversal (`leann_tpu_torch/ops/fused_beam.py`)
with the JAX reference's Pallas kernel (`leann_tpu/ops/fused_beam.py`),
which runs here in interpret mode, as its own tests run it.

On CPU the port's `fused_beam_search` runs its plain PyTorch version;
the CUDA kernel is held against that plain version on the card
(tests/test_torch_cuda.py, marked `cuda`, and chip_smoke.py).
Tolerances: packed records byte-equal; beam ids and visited logs equal
on >= 99% of positions and int8-path scores atol 1e-4 (differences come
only from float32 summation order); engine top-10 overlap >= 0.99 with
rescored scores rtol 1e-5 where ids agree."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from leann_tpu.ops import fused_beam as jf
from leann_tpu.ops.distance import exact_topk
from leann_tpu_torch.ops import fused_beam as tf

# the suite runs in several worker processes that share the CPUs: one
# intra-op thread each keeps PyTorch's many small ops from oversubscribing
torch.set_num_threads(1)


def _corpus(n, d, seed=0, clusters=32):
    # scaled by 1/8 (exact in float32) so l2 scores stay O(10) and an
    # absolute 1e-4 measures summation-order noise, not magnitude
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((clusters, d)).astype(np.float32) * 3
    x = c[rng.integers(0, clusters, n)] + rng.standard_normal((n, d)).astype(
        np.float32)
    return (x / 8).astype(np.float32)


def _graph(x, r, long_edges=4, seed=0):
    """Exact kNN rows plus a few random long edges (navigable, cheap)."""
    n = len(x)
    _, nn = exact_topk(x, x, r + 1, metric="l2")
    rng = np.random.default_rng(seed)
    adj = np.asarray([[j for j in row.tolist() if j != i][: r - long_edges]
                      for i, row in enumerate(nn)], dtype=np.int32)
    far = rng.integers(0, n, (n, long_edges)).astype(np.int32)
    far = np.where(far == np.arange(n)[:, None], (far + 1) % n, far)
    return np.concatenate([adj, far], axis=1)


@pytest.fixture(scope="module")
def packed():
    n, d, r = 700, 128, 16
    x = _corpus(n, d)
    adj = _graph(x, r)
    x1 = np.concatenate([x, np.zeros((1, d), np.float32)])
    a1 = np.concatenate([adj, np.full((1, r), n, np.int32)])
    jb, jm = jf.pack_fused(jnp.asarray(x1), jnp.asarray(a1))
    tb, tm = tf.pack_fused(torch.from_numpy(x1), torch.from_numpy(a1))
    return dict(x=x, x1=x1, adj=adj, a1=a1, n=n, d=d, r=r,
                jb=np.asarray(jb), jm=np.asarray(jm), tb=tb, tm=tm)


def test_pack_fused_byte_equal(packed):
    np.testing.assert_array_equal(packed["tb"].numpy(), packed["jb"])
    np.testing.assert_array_equal(packed["tm"].numpy(), packed["jm"])


def test_repack_rows_byte_equal(packed):
    n, r = packed["n"], packed["r"]
    a2 = packed["a1"].copy()
    rows = np.array([3, 17, 400, n, n], np.int32)      # pad rows = sentinel
    a2[[3, 17, 400]] = np.random.default_rng(9).integers(0, n, (3, r))
    jq = jf.quantize_corpus(jnp.asarray(packed["x1"]))
    jb, jm = jf.repack_rows(
        jnp.asarray(packed["jb"]), jnp.asarray(packed["jm"]), *jq,
        jnp.asarray(a2), jnp.asarray(rows))
    tq = tf.quantize_corpus(torch.from_numpy(packed["x1"]))
    for a, b in zip(tq, jq):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tb, tm = tf.repack_rows(
        packed["tb"].clone(), packed["tm"].clone(), *tq,
        torch.from_numpy(a2), torch.from_numpy(rows))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_state_from_reference_packs_like_reference(packed):
    st = tf.state_from_reference(packed["x"], packed["adj"], medoid=5,
                                 device="cpu")
    np.testing.assert_array_equal(st["blocks"].numpy(), packed["jb"])
    np.testing.assert_array_equal(st["meta"].numpy(), packed["jm"])
    assert st["corpus"].shape == (packed["n"] + 1, packed["d"])
    assert (st["corpus"][-1] == 0).all()
    je = jf.FusedBeamEngine(packed["x"], packed["adj"], 5, metric="l2",
                            qb=8, interpret=True)
    np.testing.assert_array_equal(st["seed_ids"].numpy(),
                                  np.asarray(je.seed_ids))


def test_bitonic_desc_sorts_and_carries():
    rng = np.random.default_rng(1)
    sc = rng.standard_normal((4, 64)).astype(np.float32)
    ids = np.arange(4 * 64, dtype=np.int64).reshape(4, 64)
    exp = rng.random((4, 64)) < 0.5
    s_sc, s_id, s_exp = tf._bitonic_desc(
        torch.from_numpy(sc), torch.from_numpy(ids), torch.from_numpy(exp))
    order = np.argsort(-sc, axis=1)
    np.testing.assert_array_equal(s_sc.numpy(), np.take_along_axis(sc, order, 1))
    np.testing.assert_array_equal(s_id.numpy(), np.take_along_axis(ids, order, 1))
    np.testing.assert_array_equal(s_exp.numpy(), np.take_along_axis(exp, order, 1))


@pytest.mark.parametrize("metric,expansions,track", [
    ("l2", 2, 160), ("l2", 1, 0), ("ip", 2, 0), ("ip", 1, 160)])
def test_plain_matches_reference_kernel(packed, metric, expansions, track):
    """fused_beam_search_plain vs the Pallas kernel in interpret mode, on
    an odd batch (7 queries; the reference pads to qb=8) with `exclude`."""
    n, d, r = packed["n"], packed["d"], packed["r"]
    rng = np.random.default_rng(3)
    b, L, qb = 7, 32, 8
    x1 = packed["x1"]
    q = x1[rng.integers(0, n, qb)] + rng.standard_normal(
        (qb, d)).astype(np.float32) * 0.02
    medoid = 11
    nsq = (x1 ** 2).sum(1)
    seed_sc = (2.0 * q @ x1[medoid] - nsq[medoid] if metric == "l2"
               else q @ x1[medoid]).astype(np.float32)
    excl = np.full(qb, -1, np.int32)
    excl[:4] = rng.integers(0, n, 4)
    kw = dict(r=r, beam_width=L, max_iters=80, metric=metric,
              expansions=expansions, qb=qb, ring_size=256,
              track_visited=track)
    jo = jf.fused_beam_search(
        jnp.asarray(q), jnp.asarray(packed["jb"]), jnp.asarray(packed["jm"]),
        jnp.full((qb, 1), medoid, jnp.int32), jnp.asarray(seed_sc)[:, None],
        jnp.asarray(excl), interpret=True, **kw)
    launches = tf.fused_beam_search.launches
    to = tf.fused_beam_search(
        torch.from_numpy(q[:b]), packed["tb"], packed["tm"],
        torch.full((b, 1), medoid, dtype=torch.int32),
        torch.from_numpy(seed_sc[:b, None].copy()),
        torch.from_numpy(excl[:b]), **kw)
    assert len(to) == len(jo) == (3 if track else 2)
    ji, js = np.asarray(jo[0])[:b], np.asarray(jo[1])[:b]
    ti, ts = to[0].numpy(), to[1].numpy()
    assert ti.dtype == np.int32 and ti.shape == (b, L)
    assert (ti == ji).mean() >= 0.99
    same = (ti == ji) & np.isfinite(js)
    np.testing.assert_allclose(ts[same], js[same], rtol=0, atol=1e-4)
    if track:
        jv, tv = np.asarray(jo[2])[:b], to[2].numpy()
        assert tv.shape == jv.shape == (b, 256)
        assert (tv == jv).mean() >= 0.99
    # the wrapper took the plain path: no kernel launch on CPU tensors
    assert tf.fused_beam_search.launches == launches


@pytest.mark.parametrize("metric,expansions,track", [
    ("l2", 2, 160), ("ip", 1, 128)])
def test_plain_query_groups_equal_reference_on_duplicates(metric, expansions,
                                                          track):
    """Query groups of qb=4 on a corpus where every row appears two or
    three times, so converged beams hold equal int8 scores: a converged
    query keeps taking (empty) merges while its group is active, and
    the bitonic network reorders its ties, as in the Pallas kernel.
    Queries are small integers, so every int8 dot is an exact integer in
    float32 in any summation order: ids, scores and the visited log must
    be equal exactly."""
    n0, d, r, b, qb, L = 240, 128, 12, 16, 4, 16
    base = _corpus(n0, d, seed=4)
    rng = np.random.default_rng(4)
    x = np.concatenate([base, base, base[: n0 // 2]])
    x = x[rng.permutation(len(x))]
    n = len(x)
    adj = _graph(x, r, seed=4)
    x1 = np.concatenate([x, np.zeros((1, d), np.float32)])
    a1 = np.concatenate([adj, np.full((1, r), n, np.int32)])
    jb, jm = jf.pack_fused(jnp.asarray(x1), jnp.asarray(a1))
    tb, tm = tf.pack_fused(torch.from_numpy(x1), torch.from_numpy(a1))
    q = np.clip(np.round(x[rng.integers(0, n, b)] * 4), -6, 6).astype(
        np.float32)
    medoid = 7
    nsq = (x1 ** 2).sum(1)
    seed_sc = (2.0 * q @ x1[medoid] - nsq[medoid] if metric == "l2"
               else q @ x1[medoid]).astype(np.float32)
    excl = np.full(b, -1, np.int32)
    kw = dict(r=r, beam_width=L, max_iters=60, metric=metric,
              expansions=expansions, qb=qb, ring_size=256,
              track_visited=track)
    jo = jf.fused_beam_search(
        jnp.asarray(q), jnp.asarray(np.asarray(jb)), jnp.asarray(np.asarray(jm)),
        jnp.full((b, 1), medoid, jnp.int32), jnp.asarray(seed_sc)[:, None],
        jnp.asarray(excl), interpret=True, **kw)
    to = tf.fused_beam_search(
        torch.from_numpy(q), tb, tm, torch.full((b, 1), medoid, dtype=torch.int32),
        torch.from_numpy(seed_sc[:, None].copy()), torch.from_numpy(excl), **kw)
    assert len(to) == len(jo) == 3
    sc = np.asarray(jo[1])
    ties = (sc[:, 1:] == sc[:, :-1]) & np.isfinite(sc[:, 1:])
    assert ties.any(), "the corpus must put tied scores in the beams"
    for a, ref in zip(to, jo):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ref))


def test_engine_matches_reference_engine(packed):
    """FusedBeamEngine.search: top-10 overlap >= 0.99 with the reference
    engine, rescored scores rtol 1e-5 where ids agree; exclude honoured."""
    n, d = packed["n"], packed["d"]
    x, adj = packed["x"], packed["adj"]
    rng = np.random.default_rng(5)
    q = x[rng.integers(0, n, 8)] + rng.standard_normal((8, d)).astype(
        np.float32) * 0.02
    excl = np.array([3, 5, 7, 9, 11, 13, 15, 17], np.int32)
    je = jf.FusedBeamEngine(x, adj, 0, metric="l2", qb=8, ring_size=256,
                            interpret=True)
    te = tf.FusedBeamEngine(x, adj, 0, metric="l2", qb=8, ring_size=256,
                            device="cpu")
    ji, js = je.search(q, k=10, beam_width=32, exclude=excl)
    ti, ts = te.search(q[:7], k=10, beam_width=32, exclude=excl[:7])
    ji, js = ji[:7], js[:7]
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                       for a, b in zip(ti, ji)])
    assert overlap >= 0.99, overlap
    same = ti == ji
    np.testing.assert_allclose(ts[same], js[same], rtol=1e-5)
    for row, e in zip(ti, excl):
        assert e not in row
    assert (np.diff(ts, axis=1) <= 1e-5).all()


def test_engine_recall_and_cosine():
    n, d = 600, 128
    x = _corpus(n, d, seed=2) * 8
    adj = _graph(x, 16, seed=2)
    rng = np.random.default_rng(6)
    q = x[rng.integers(0, n, 12)] + rng.standard_normal((12, d)).astype(
        np.float32) * 0.05
    for metric in ("l2", "cosine"):
        te = tf.FusedBeamEngine(x, adj, 0, metric=metric, qb=8,
                                ring_size=256, device="cpu")
        idx, _ = te.search(q, k=10, beam_width=32)
        _, oracle = exact_topk(q, x, 10, metric=metric)
        rec = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                       for a, b in zip(idx, oracle)])
        assert rec >= 0.9, (metric, rec)


def test_search_many_device_matches_search_device(packed):
    te = tf.FusedBeamEngine(packed["x"], packed["adj"], 0, metric="ip",
                            qb=8, ring_size=256, device="cpu")
    rng = np.random.default_rng(8)
    qs = torch.from_numpy(packed["x"][rng.integers(0, packed["n"], (2, 8))])
    ids_m, sc_m = te.search_many_device(qs, k=10, beam_width=32)
    assert ids_m.shape == (2, 8, 10)
    for m in range(2):
        ids_1, sc_1 = te.search_device(qs[m].numpy(), k=10, beam_width=32)
        assert torch.equal(ids_m[m], ids_1)
        assert torch.equal(sc_m[m], sc_1)
    with pytest.raises(ValueError):
        te.search_many_device(qs[:, :6], k=10)


def test_wrapper_rejects_bad_inputs(packed):
    q = torch.zeros((2, packed["d"]))
    seeds = torch.zeros((2, 1), dtype=torch.int32)
    sc = torch.zeros((2, 1))
    exc = torch.full((2,), -1, dtype=torch.int32)
    kw = dict(r=packed["r"], beam_width=16, max_iters=4, metric="l2")
    with pytest.raises(TypeError):
        tf.fused_beam_search(q, packed["tb"], packed["tm"], seeds.long(), sc,
                             exc, **kw)
    with pytest.raises(ValueError):
        tf.fused_beam_search(q, packed["tb"], packed["tm"], seeds, sc, exc,
                             expansions=3, **kw)
    with pytest.raises(ValueError):
        tf.fused_beam_search(q[:, :64], packed["tb"], packed["tm"], seeds, sc,
                             exc, **kw)
