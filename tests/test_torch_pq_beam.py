"""Parity of the port's PQ graph engine (`leann_tpu_torch/ops/pq_beam.py`)
with the JAX reference (`leann_tpu/ops/pq_beam.py`), whose Pallas kernel
runs here in interpret mode, as its own tests run it.

On CPU the port's `pq_beam_search` runs its plain PyTorch version; the
CUDA kernel is held against that plain version on the card
(tests/test_torch_cuda.py, marked `cuda`, and chip_smoke.py).
Tolerances: packed records byte-equal; the traversal on identical LUTs,
records and seeds equal exactly (ids, scores and visited log: the plain
version reproduces the kernel's bf16 roundings, its query groups and its
wrapping log); the engines, given the same codebooks and codes, top-10
overlap >= 0.98 and recall within 0.02 (the LUT GEMM and the seed matmul
may differ in the last bit)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from leann_tpu.ops import pq_beam as jp
from leann_tpu.ops.distance import exact_topk
from leann_tpu.ops.pq import (
    adc_affine, encode_pq, encode_residual_pq, quantize_norms, train_pq,
    train_residual_pq,
)
from leann_tpu.ops.vamana import build_vamana
from leann_tpu_torch.ops import pq_beam as tp

torch.set_num_threads(1)


def _corpus(n, d, seed=0, clusters=24):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((clusters, d)).astype(np.float32) * 4.0
    return (c[rng.integers(0, clusters, n)]
            + rng.standard_normal((n, d)).astype(np.float32))


def _recall(idx, oracle):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                    for a, b in zip(idx, oracle)])


def _overlap(a, b):
    return np.mean([len(set(x.tolist()) & set(y.tolist())) / 10
                    for x, y in zip(a, b)])


@pytest.fixture(scope="module")
def graph():
    n, d, r = 1500, 64, 16
    x = _corpus(n, d)
    adj, medoid = build_vamana(x, graph_degree=r, complexity=32,
                               metric="l2", wave_size=512)
    return dict(x=x, adj=adj, medoid=medoid, n=n, d=d, r=r,
                a1=np.concatenate([adj, np.full((1, r), n, np.int32)]))


@pytest.mark.parametrize("r,m,bits", [(48, 16, 4), (48, 16, 8), (32, 24, 8),
                                      (128, 16, 4), (16, 8, 4)])
def test_pq_layout_matches_reference(r, m, bits):
    assert tp.pq_layout(r, m, bits) == jp.pq_layout(r, m, bits)


@pytest.mark.parametrize("bits", [4, 8])
def test_pack_records_byte_equal(bits):
    """R=48, m=16: 8-bit words with codes >= 128 at shift 24 set the
    sign bit; tail packing spills to plane 1."""
    n, r, m = 700, 48, 16
    rng = np.random.default_rng(1)
    adj = rng.integers(0, n, (n + 1, r)).astype(np.int32)
    adj[n] = n
    codes = rng.integers(0, 1 << bits, (n + 1, m)).astype(np.uint8)
    codes[n] = 0
    want = jp.pack_pq_records_host(adj, codes, bits)
    got = tp.pack_pq_records_host(adj, codes, bits, chunk=300)
    assert got.dtype == np.int32 and (want < 0).any()
    np.testing.assert_array_equal(got, want)

    rows = np.array([3, 17, 400, n, n], np.int32)   # pad rows = sentinel
    adj2 = adj.copy()
    adj2[[3, 17, 400]] = rng.integers(0, n, (3, r))
    want2 = jp.repack_pq_rows(jnp.asarray(want), jnp.asarray(adj2),
                              jnp.asarray(codes), jnp.asarray(rows), bits)
    got2 = tp.repack_pq_rows(torch.from_numpy(got), torch.from_numpy(adj2),
                             torch.from_numpy(codes), torch.from_numpy(rows),
                             bits)
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))


def _kernel_case(graph, ksub, metric, e, vt, coarse=0):
    """Identical LUTs, records, seeds and exclude for both packages: two
    query groups of qb=8, ADC-scored seeds, half the queries excluding a
    node."""
    x, n, d, r = graph["x"], graph["n"], graph["d"], graph["r"]
    rng = np.random.default_rng(ksub + e + vt + (metric == "ip"))
    if coarse:
        bc, bf = train_residual_pq(x, mc=coarse, mf=8, ksub=256, iters=3)
        codes, nsq = encode_residual_pq(x, bc, bf)
        nq, off, scale = quantize_norms(nsq)
        codes = np.concatenate([codes, nq], axis=1)
        w, bb = adc_affine(d, metric, bc, bf, 256, off, scale)
        bits = 8
    else:
        books = train_pq(x, m=16, ksub=ksub, iters=3)
        codes = encode_pq(x, books)
        w, bb = adc_affine(d, metric, None, books, ksub)
        bits = 8 if ksub > 16 else 4
    mt = codes.shape[1]
    codes1 = np.concatenate([codes, np.zeros((1, mt), np.uint8)])
    rec = jp.pack_pq_records_host(graph["a1"], codes1, bits)
    b = 16
    q = x[rng.integers(0, n, b)] + rng.standard_normal((b, d)).astype(
        np.float32) * 0.05
    luts = (q @ w.reshape(-1, d).T + bb.reshape(-1)).astype(np.float32)
    seeds = rng.choice(n, (b, 6)).astype(np.int32)
    cols = np.arange(mt)[None, None, :] * w.shape[1] + codes[seeds]
    seed_sc = np.take_along_axis(luts[:, None, :], cols, 2).sum(2)
    order = np.argsort(-seed_sc, axis=1, kind="stable")
    seeds = np.take_along_axis(seeds, order, 1)
    seed_sc = np.take_along_axis(seed_sc, order, 1).astype(np.float32)
    excl = np.where(rng.random(b) < 0.5, rng.integers(0, n, b), -1).astype(
        np.int32)
    kw = dict(r=r, m=mt, ksub=w.shape[1], bits=bits, beam_width=32,
              max_iters=60, expansions=e, qb=8, ring_size=256,
              track_visited=vt)
    return (luts, rec, seeds, seed_sc, excl), kw


@pytest.mark.parametrize("ksub,metric,e,vt", [
    (16, "l2", 2, 128), (16, "ip", 1, 0), (16, "l2", 1, 128),
    (16, "ip", 2, 0), (256, "l2", 2, 128), (256, "ip", 2, 0),
    (256, "ip", 1, 128), (256, "l2", 1, 0)])
def test_plain_equals_reference_kernel(graph, ksub, metric, e, vt):
    """pq_beam_search (plain on CPU tensors) vs the Pallas kernel in
    interpret mode: ids, scores and visited log equal exactly. At
    max_iters 60 the log of 128 lanes wraps."""
    args, kw = _kernel_case(graph, ksub, metric, e, vt)
    jo = jp.pq_beam_search(*map(jnp.asarray, args), interpret=True, **kw)
    launches = tp.pq_beam_search.launches
    to = tp.pq_beam_search(*map(torch.from_numpy, args), **kw)
    assert tp.pq_beam_search.launches == launches   # plain path on CPU
    assert len(to) == len(jo) == (3 if vt else 2)
    assert to[0].dtype == torch.int32 and to[0].shape == (16, 32)
    for a, b in zip(to, jo):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if vt:   # the log wrapped and ends in sentinel writes
        assert (to[2].numpy() == graph["n"]).any()


def test_plain_equals_reference_kernel_residual(graph):
    """Residual mode: mc=2 + mf=8 + 2 l2 norm columns (mt=12)."""
    args, kw = _kernel_case(graph, 256, "l2", 2, 128, coarse=2)
    assert kw["m"] == 12
    jo = jp.pq_beam_search(*map(jnp.asarray, args), interpret=True, **kw)
    to = tp.pq_beam_search(*map(torch.from_numpy, args), **kw)
    for a, b in zip(to, jo):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_plain_query_groups(graph):
    """A query's result depends on its group of qb consecutive queries
    (a converged query takes empty merges while its group is active, and
    they reorder equal scores): each group run alone gives the same
    rows, an odd batch ends in a short group, and one-query groups give
    other ids on this data."""
    args, kw = _kernel_case(graph, 256, "l2", 2, 128)
    full = tp.pq_beam_search(*map(torch.from_numpy, args), **kw)
    for g in (slice(0, 8), slice(8, 16), slice(0, 13)):
        part = tp.pq_beam_search(*(torch.from_numpy(a if i == 1 else a[g])
                                   for i, a in enumerate(args)), **kw)
        for a, b in zip(part, full):
            assert torch.equal(a[:8], b[g][:8])
    alone = tp.pq_beam_search(*map(torch.from_numpy, args),
                              **dict(kw, qb=1))
    assert torch.equal(alone[1], full[1])        # the same score multiset
    assert not torch.equal(alone[0], full[0])


@pytest.mark.parametrize("metric,ksub,rescore", [
    ("l2", 256, "f32"), ("ip", 16, "bf16"), ("l2", 16, "int8")])
def test_engine_matches_reference_engine(graph, metric, ksub, rescore):
    """PqBeamEngine.search vs the reference engine given the same
    codebooks and codes: top-10 overlap >= 0.98, recall within 0.02,
    exclude honoured, scores descending."""
    x, adj, med, n, d = (graph[k] for k in ("x", "adj", "medoid", "n", "d"))
    kw = dict(metric=metric, m=16, ksub=ksub, qb=8, ring_size=256,
              visited_pool=128, rescore=rescore)
    je = jp.PqBeamEngine(x, adj, med, interpret=True, **kw)
    te = tp.PqBeamEngine(x, adj, med, codebooks=je.codebooks,
                         codes=np.asarray(je.codes), device="cpu", **kw)
    np.testing.assert_array_equal(te.records.numpy(), np.asarray(je.records))
    np.testing.assert_array_equal(te.seed_ids.numpy(), np.asarray(je.seed_ids))
    rng = np.random.default_rng(4)
    q = x[rng.integers(0, n, 15)] + rng.standard_normal((15, d)).astype(
        np.float32) * 0.05
    excl = rng.integers(0, n, 15).astype(np.int32)
    ji, js = je.search(q, k=10, beam_width=32, exclude=excl)
    ti, ts = te.search(q, k=10, beam_width=32, exclude=excl)
    assert ti.shape == (15, 10)
    assert _overlap(ti, ji) >= 0.98
    _, oracle = exact_topk(q, x, 10, metric=metric)
    assert abs(_recall(ti, oracle) - _recall(ji, oracle)) <= 0.02
    for row, e in zip(ti, excl):
        assert e not in row
    assert (np.diff(ts, axis=1) <= 1e-5).all()


def test_engine_residual_and_opq_match_reference(graph):
    from leann_tpu.ops.pq import train_opq

    x, adj, med, n, d = (graph[k] for k in ("x", "adj", "medoid", "n", "d"))
    rot, _ = train_opq(x, m=8, ksub=64, iters=4, opq_iters=2)
    kw = dict(metric="l2", m=8, ksub=256, qb=8, ring_size=256,
              visited_pool=128, coarse_m=2, rotation=rot)
    je = jp.PqBeamEngine(x, adj, med, interpret=True, kmeans_iters=4, **kw)
    te = tp.PqBeamEngine(x, adj, med, codebooks=je.codebooks,
                         codes=np.asarray(je.codes), device="cpu", **kw)
    assert te.mt == je.mt == 12
    np.testing.assert_array_equal(te.records.numpy(), np.asarray(je.records))
    rng = np.random.default_rng(9)
    q = x[rng.integers(0, n, 16)] + rng.standard_normal((16, d)).astype(
        np.float32) * 0.05
    ji, _ = je.search(q, k=10, beam_width=32)
    ti, ts = te.search(q, k=10, beam_width=32)
    assert _overlap(ti, ji) >= 0.98
    i0 = ti[0, 0]
    want = 2 * float(q[0] @ x[i0]) - float(x[i0] @ x[i0])
    np.testing.assert_allclose(ts[0, 0], want, rtol=1e-4)


def test_engine_trains_and_searches_alone(graph):
    """No codebooks given: the port trains its own (same numpy draws of
    the sample and seed pool as the reference) and reaches the
    reference's recall at d=64, 8-bit codes."""
    x, adj, med, n, d = (graph[k] for k in ("x", "adj", "medoid", "n", "d"))
    te = tp.PqBeamEngine(x, adj, med, metric="l2", m=16, ksub=256, qb=8,
                         ring_size=256, visited_pool=128, kmeans_iters=4,
                         device="cpu")
    je_seeds = jp.PqBeamEngine(x, adj, med, metric="l2", m=16, ksub=256,
                               qb=8, kmeans_iters=4, interpret=True).seed_ids
    np.testing.assert_array_equal(te.seed_ids.numpy(), np.asarray(je_seeds))
    rng = np.random.default_rng(2)
    q = x[rng.integers(0, n, 8)] + rng.standard_normal((8, d)).astype(
        np.float32) * 0.05
    idx, _ = te.search(q, k=10, beam_width=32)
    _, oracle = exact_topk(q, x, 10, metric="l2")
    assert _recall(idx, oracle) >= 0.8


def test_search_many_device_matches_search_device(graph):
    x, adj, med = graph["x"], graph["adj"], graph["medoid"]
    te = tp.PqBeamEngine(x, adj, med, metric="l2", m=16, ksub=16, qb=8,
                         ring_size=256, visited_pool=128, kmeans_iters=3,
                         device="cpu")
    rng = np.random.default_rng(8)
    qs = torch.from_numpy(x[rng.integers(0, graph["n"], (2, 8))])
    ids_m, sc_m = te.search_many_device(qs, k=10, beam_width=32)
    assert ids_m.shape == (2, 8, 10)
    for m in range(2):
        ids_1, sc_1 = te.search_device(qs[m].numpy(), k=10, beam_width=32)
        assert torch.equal(ids_m[m], ids_1)
        assert torch.equal(sc_m[m], sc_1)
    with pytest.raises(ValueError):
        te.search_many_device(qs[:, :6], k=10)


def test_wrapper_rejects_bad_inputs(graph):
    args, kw = _kernel_case(graph, 16, "l2", 2, 0)
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(TypeError):
        tp.pq_beam_search(t[0], t[1], t[2].long(), *t[3:], **kw)
    with pytest.raises(ValueError):
        tp.pq_beam_search(*t, **dict(kw, expansions=3))
    with pytest.raises(ValueError):
        tp.pq_beam_search(t[0][:, :-1], *t[1:], **kw)
    with pytest.raises(ValueError):
        tp.pq_beam_search(t[0], t[1][:, :, :64], *t[2:], **kw)


def test_graph_searcher_pq_engine_and_sidecar(tmp_path, monkeypatch):
    """LEANN_GRAPH_ENGINE=pq on the CPU: GraphSearcher serves through
    PqBeamEngine (the plain kernel version); the `.pq.npz` sidecar the
    port writes loads in the reference and the reference's loads in the
    port, without retraining; a rebuild invalidates it."""
    from leann_tpu.store import pqfile as jpqfile
    from leann_tpu_torch.backend import load_searcher
    from leann_tpu_torch.index.builder import IndexBuilder
    from leann_tpu_torch.store import pqfile
    from leann_tpu_torch.store.meta import IndexMeta, meta_path

    monkeypatch.setenv("LEANN_GRAPH_ENGINE", "pq")
    base = str(tmp_path / "documents.leann")
    rng = np.random.default_rng(7)
    n, d = 300, 32
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    builder = IndexBuilder(base, dim=d, backend="vamana", device="cpu")
    for i in range(n):
        builder.add(f"p{i}", f"passage {i}", vecs[i], {"n": i})
    builder.build()
    meta = IndexMeta.load(meta_path(base))

    s1 = load_searcher(base, meta, device="cpu")
    assert isinstance(s1.engine, tp.PqBeamEngine)
    assert s1.engine.ksub == 256 and s1.engine.m == 16
    assert os.path.exists(pqfile.pq_path(base))
    idx, _ = s1.search(vecs[5:6], k=3, complexity=32)
    assert 5 in idx[0]
    books, codes, rot = jpqfile.load_pq(base, n, meta.metric)
    np.testing.assert_array_equal(codes, s1.engine.codes)
    assert rot is None

    # a reload reuses the sidecar: training is poisoned
    def boom(*a, **k):  # pragma: no cover
        raise AssertionError("PQ retrained despite persisted sidecar")

    monkeypatch.setattr(tp, "train_pq", boom)
    s2 = load_searcher(base, meta, device="cpu")
    idx2, _ = s2.search(vecs[5:6], k=3, complexity=32)
    np.testing.assert_array_equal(idx, idx2)

    # the reference's sidecar loads in the port
    jpqfile.save_pq(base, books * 0 + 1, codes[:, ::-1], n, meta.metric)
    s3 = load_searcher(base, meta, device="cpu")
    np.testing.assert_array_equal(s3.engine.codes, codes[:, ::-1])

    # rebuild at the same base invalidates the sidecar
    builder = IndexBuilder(base, dim=d, backend="vamana", device="cpu")
    for i in range(50):
        builder.add(f"q{i}", f"new passage {i}", vecs[i], {"n": i})
    builder.build()
    assert not os.path.exists(pqfile.pq_path(base))


def test_graph_searcher_opq_knob(tmp_path, monkeypatch):
    from leann_tpu_torch.backend import GraphSearcher
    from leann_tpu_torch.store import pqfile
    from leann_tpu_torch.store.graphfile import GraphFile
    from leann_tpu_torch.ops.vamana import build_vamana as tbuild

    monkeypatch.setenv("LEANN_GRAPH_ENGINE", "pq")
    monkeypatch.setenv("LEANN_PQ_OPQ", "1")
    monkeypatch.setenv("LEANN_PQ_RESCORE", "int8")
    rng = np.random.default_rng(17)
    vecs = rng.standard_normal((300, 32)).astype(np.float32)
    adj, med = tbuild(vecs, graph_degree=16, complexity=32, metric="l2",
                      device="cpu")
    base = str(tmp_path / "x.leann")
    s = GraphSearcher(vecs, GraphFile(adj, med, "l2"), metric="l2",
                      base=base, device="cpu")
    assert s.engine.rotation is not None and s.engine.corpus.dtype == torch.int8
    assert pqfile.load_pq(base, 300, "l2", want_rot=False) is None
    assert pqfile.load_pq(base, 300, "l2", want_rot=True)[2] is not None
    idx, _ = s.search(vecs[7:8], k=3, complexity=32)
    assert 7 in idx[0]


def test_graph_searcher_cpu_auto_stays_inline(monkeypatch):
    from leann_tpu_torch.backend import GraphSearcher
    from leann_tpu_torch.ops.beam import BeamSearchEngine
    from leann_tpu_torch.store.graphfile import GraphFile

    monkeypatch.delenv("LEANN_GRAPH_ENGINE", raising=False)
    vecs = np.random.default_rng(0).standard_normal((64, 96)).astype(
        np.float32)
    g = GraphFile(np.zeros((64, 8), np.int32), 0, "l2")
    s = GraphSearcher(vecs, g, metric="l2", device="cpu")
    assert isinstance(s.engine, BeamSearchEngine)


def _pi_power(pi, n):
    """pi^n of a permutation given as 'output f takes input pi[f]', by
    repeated squaring (the CUDA settle pass computes it so)."""
    out = np.arange(len(pi))
    base = np.asarray(pi)
    while n:
        if n & 1:
            out = base[out]
        base = base[base]
        n >>= 1
    return out


@pytest.mark.parametrize("p2,beam,e", [(256, 100, 1), (512, 256, 2),
                                       (1024, 400, 2)])
def test_empty_merges_are_one_permutation_raised_to_a_power(p2, beam, e):
    """A converged beam (live prefix non-increasing, then (-inf,
    sentinel)) under n empty merges, each `_bitonic_desc` over [beam |
    (-inf, sentinel) pad] with the entries past L killed, equals pi^n on
    its live prefix, pi being the network's permutation from one run:
    ids and score bits (+0.0 and -0.0 tie but differ), n up to the
    engine's max_iters. This is what lets the settle pass take pi^idle
    instead of idle merges."""
    from leann_tpu_torch.ops.fused_beam import _bitonic_desc, _sizes

    assert _sizes(beam, e, 1024, 0)[1] == p2
    max_iters = (4 * beam) // e + 32
    rng = np.random.default_rng(p2)
    q, sentinel = 6, 10**6
    levels = np.array([2.5, 1.0, 0.0, -0.0, -1.0], np.float32)
    sc = np.full((q, beam), -np.inf, np.float32)
    ids = np.full((q, beam), sentinel, np.int64)
    live = rng.integers(beam // 2, beam + 1, q)
    live[0] = beam
    for i in range(q):
        sc[i, : live[i]] = -np.sort(-rng.choice(levels, live[i]))
        ids[i, : live[i]] = rng.permutation(sentinel)[: live[i]]
    assert (sc.view(np.uint32) == np.float32(-0.0).view(np.uint32)).any()
    steps = rng.integers(1, max_iters + 1, q)
    steps[0] = max_iters

    def pad(x, fill):
        return torch.cat([torch.from_numpy(x), torch.full(
            (q, p2 - beam), fill, dtype=torch.from_numpy(x).dtype)], 1)

    flags = torch.zeros((q, p2), dtype=torch.bool)
    _, pi, _ = _bitonic_desc(pad(sc, -np.inf),
                             torch.arange(p2).repeat(q, 1), flags)
    cur_sc, cur_id = torch.from_numpy(sc), torch.from_numpy(ids)
    for n in range(1, max_iters + 1):
        s, i, _ = _bitonic_desc(pad(cur_sc.numpy(), -np.inf),
                                pad(cur_id.numpy(), sentinel), flags)
        cur_sc, cur_id = s[:, :beam], i[:, :beam]
        for row in np.flatnonzero(steps == n):
            nl = live[row]
            p = pi[row, :nl].numpy()
            assert sorted(p.tolist()) == list(range(nl))
            want = _pi_power(p, n)
            np.testing.assert_array_equal(cur_id[row, :nl].numpy(),
                                          ids[row, want])
            np.testing.assert_array_equal(
                cur_sc[row, :nl].numpy().view(np.uint32),
                sc[row, want].view(np.uint32))
            assert (cur_id[row, nl:] == sentinel).all()
            assert torch.isneginf(cur_sc[row, nl:]).all()


def test_tied_order_is_not_a_function_of_positions():
    """Why the merge runs the network: no sort key of (score, input
    position) reproduces its order of ties. In the merge's shape (a
    sorted beam of 2, 4 candidates, -inf pad) the tied entries at
    positions 1 and 3 leave in one order, and in the other once the
    candidate at position 2 scores 2 instead of 0."""
    from leann_tpu_torch.ops.fused_beam import _bitonic_desc

    ninf = float("-inf")
    x = torch.tensor([[1.0, 0.0, 0.0, 0.0, 0.0, 0.0, ninf, ninf],
                      [1.0, 0.0, 2.0, 0.0, 0.0, 0.0, ninf, ninf]])
    pos = torch.arange(8).repeat(2, 1)
    _, order, _ = _bitonic_desc(x, pos, torch.zeros_like(pos, dtype=torch.bool))
    first, second = order.tolist()
    assert first.index(1) < first.index(3)
    assert second.index(3) < second.index(1)
