"""Tests of the port's CUDA kernels: they need a card and skip without
one. This file imports neither JAX nor `leann_tpu`, so on a machine with
a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the traversal kernels (B1, B3) exactly: the plain versions
sum in the kernels' order, so ids, scores and visited logs are equal.
B1 merges a hop by rank where the live scores are distinct and with the
bitonic network where they tie; `merge_stats=True` returns per query the
hops that took the network ("slow merges") and the active hops, and the
plain version counts them alike, so the counts are held equal too. The B1
cases of the smoke alone, on a card: `python -c "import torch,
chip_smoke; chip_smoke.phase_kernels(torch, torch.device('cuda'))"`.
The bucket kernels (B2, B4): -inf positions equal exactly, finite scores
within 1e-5 x |q| x (largest row norm) (l2: twice that), since their
plain versions add the same exact products in another order; NaN rows
exactly at probes outside [0, K); a repeat gives the same bits; the
same tolerance against their earlier designs (`csrc/*_pairs.cu`). The row
gather (B5): within 1e-5 x |q| x (largest row norm), for the same
reason."""

import numpy as np
import pytest
import torch

from leann_tpu_torch.ops import bucket_kernels as tbk
from leann_tpu_torch.ops import fused_beam as tf
from leann_tpu_torch.ops import gather_score as tgs
from leann_tpu_torch.ops import pq_beam as tp
from leann_tpu_torch.ops.vamana import build_vamana

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def graph(dev):
    rng = np.random.default_rng(0)
    n, d = 3000, 128
    c = rng.standard_normal((32, d)).astype(np.float32) * 3
    x = (c[rng.integers(0, 32, n)]
         + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)
    adj, medoid = build_vamana(x, graph_degree=24, complexity=48,
                               metric="l2", wave_size=1024, device=dev)
    return x, adj, medoid


def kernel_equals_plain(kw):
    """B1 against its plain version on the card, exactly, without and
    with merge_stats (ids, scores, visited log, slow merges, hops).
    Returns (slow merges, hops) per query."""
    before = tf.fused_beam_search.launches
    got = tf.fused_beam_search(**kw)
    stats = tf.fused_beam_search(**kw, merge_stats=True)
    torch.cuda.synchronize()
    assert tf.fused_beam_search.launches == before + 2
    ref = tf.fused_beam_search_plain(**kw, merge_stats=True)
    assert len(got) == (3 if kw.get("track_visited") else 2)
    assert len(stats) == len(ref) == len(got) + 2
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    for a, r in zip(stats, ref):
        assert torch.equal(a, r)
    return stats[-2:]


def medoid_args(st, q, medoid, adj, **kw):
    """Kernel arguments with the medoid as the one seed (l2, f32 score)."""
    b = q.shape[0]
    sc = 2.0 * q @ st["corpus"][medoid] - st["sq_norms"][medoid]
    return dict(queries=q, blocks_i8=st["blocks"], meta_i32=st["meta"],
                seed_ids=torch.full((b, 1), medoid, dtype=torch.int32,
                                    device=q.device),
                seed_scores=sc[:, None].contiguous(),
                exclude=torch.full((b,), -1, dtype=torch.int32,
                                   device=q.device),
                r=adj.shape[1], metric="l2", **kw)


@pytest.mark.parametrize("metric,expansions,track", [
    ("l2", 2, 160), ("l2", 1, 0), ("ip", 2, 0), ("ip", 1, 160)])
def test_kernel_equals_plain(dev, graph, metric, expansions, track):
    """Four random seeds per query, all scored 0: the first merges tie."""
    x, adj, medoid = graph
    st = tf.state_from_reference(x, adj, medoid, device=dev)
    rng = np.random.default_rng(1)
    b = 77
    q = torch.from_numpy(x[rng.integers(0, len(x), b)] + np.float32(0.1)).to(dev)
    seeds = torch.from_numpy(
        rng.integers(0, len(x), (b, 4)).astype(np.int32)).to(dev)
    sc = torch.zeros((b, 4), device=dev)
    exc = torch.from_numpy(
        rng.integers(-1, len(x), b).astype(np.int32)).to(dev)
    slow, hops = kernel_equals_plain(dict(
        queries=q, blocks_i8=st["blocks"], meta_i32=st["meta"],
        seed_ids=seeds, seed_scores=sc, exclude=exc, r=adj.shape[1],
        beam_width=48, max_iters=120, metric=metric, expansions=expansions,
        ring_size=512, track_visited=track))
    assert bool((slow >= 1).all()) and bool((slow <= hops).all())


def test_kernel_rank_merge_on_distinct_vectors(dev, graph):
    """Gaussian vectors and the medoid as the one seed: no two live scores
    tie, so every hop merges by rank (no slow merge)."""
    x, adj, medoid = graph
    st = tf.state_from_reference(x, adj, medoid, device=dev)
    rng = np.random.default_rng(11)
    q = torch.from_numpy(x[rng.integers(0, len(x), 64)] + np.float32(0.1)).to(dev)
    for beam in (32, 64):
        slow, hops = kernel_equals_plain(medoid_args(
            st, q, medoid, adj, beam_width=beam, max_iters=150,
            expansions=2, ring_size=1024, track_visited=160))
        assert int(slow.sum()) == 0 and bool((hops > 0).all())


@pytest.mark.parametrize("expansions", [1, 2])
def test_kernel_minimum_ring(dev, graph, expansions):
    """ring_size below the sort width, so each ring holds V = P2 ids (two
    or four hops): over the search's hops ids fall out of the rings and
    are admitted again, and the table must see each ring as it stands."""
    x, adj, medoid = graph
    st = tf.state_from_reference(x, adj, medoid, device=dev)
    rng = np.random.default_rng(12)
    q = torch.from_numpy(x[rng.integers(0, len(x), 64)] + np.float32(0.1)).to(dev)
    for beam in (32, 64):
        p2 = tf._sizes(beam, expansions, 1, 0)[1]
        slow, hops = kernel_equals_plain(medoid_args(
            st, q, medoid, adj, beam_width=beam, max_iters=150,
            expansions=expansions, ring_size=1, track_visited=128))
        assert int(hops.min()) > p2 // 128


@pytest.fixture(scope="module")
def graph768(dev):
    """The rag path's shape: 768-d unit vectors, R=32, ip."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2000, 768)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    adj, medoid = build_vamana(x, graph_degree=32, complexity=64,
                               metric="ip", wave_size=1024, device=dev)
    return x, adj, medoid


@pytest.mark.parametrize("case", ["build", "search64", "search1024"])
def test_kernel_equals_plain_d768(dev, graph768, case):
    """D=768 (six 128-wide slices per dot), R=32, and at L=1024 a sort
    width of 2048 with 2048-id rings (97 KB of shared memory)."""
    x, adj, medoid = graph768
    eng = tf.FusedBeamEngine(x, adj, medoid, metric="ip", device=dev)
    b = 24
    ids = torch.arange(b, device=dev)
    q = eng.vectors[ids]
    if case == "build":
        kw = tf.wave_kernel_args(q, eng.vectors, eng.sq_norms, eng.blocks,
                                 eng.meta, eng.medoid, ids, eng.r, 64, 144,
                                 "ip", track_visited=128)
    else:
        none = torch.full((b,), -1, dtype=torch.int32, device=dev)
        kw = eng.kernel_args(q, none, 64 if case == "search64" else 1024)
    slow, hops = kernel_equals_plain(kw)
    assert bool((hops > 0).all()) and bool((slow <= hops).all())


def test_engine_on_cuda_matches_cpu(dev, graph):
    """FusedBeamEngine on the card (kernel) vs on the CPU (plain)."""
    x, adj, medoid = graph
    rng = np.random.default_rng(2)
    q = x[rng.integers(0, len(x), 40)] + np.float32(0.05)
    gpu = tf.FusedBeamEngine(x, adj, medoid, metric="l2", device=dev)
    cpu = tf.FusedBeamEngine(x, adj, medoid, metric="l2", device="cpu")
    gi, gs = gpu.search(q, k=10, beam_width=32)
    ci, cs = cpu.search(q, k=10, beam_width=32)
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                       for a, b in zip(gi, ci)])
    assert overlap >= 0.99
    same = gi == ci
    np.testing.assert_allclose(gs[same], cs[same], rtol=1e-5)


def test_wrapper_rejects_mixed_devices(dev, graph):
    x, adj, medoid = graph
    st = tf.state_from_reference(x, adj, medoid, device=dev)
    q = torch.zeros((2, 128))
    with pytest.raises(ValueError):
        tf.fused_beam_search(
            q, st["blocks"], st["meta"], torch.zeros((2, 1), dtype=torch.int32),
            torch.zeros((2, 1)), torch.full((2,), -1, dtype=torch.int32),
            r=adj.shape[1], beam_width=16, max_iters=4, metric="l2")


@pytest.fixture(scope="module")
def graph96(dev):
    """The DEEP shape: 96-d l2, R=48 (the PQ engine's territory)."""
    rng = np.random.default_rng(4)
    basis, _ = np.linalg.qr(rng.standard_normal((96, 16)))
    lat = (4.0 * rng.standard_normal((32, 16)))[rng.integers(0, 32, 3000)]
    x = ((lat + rng.standard_normal((3000, 16))) @ basis.T
         + 0.05 * rng.standard_normal((3000, 96))).astype(np.float32)
    adj, medoid = build_vamana(x, graph_degree=48, complexity=64,
                               metric="l2", wave_size=1024, device=dev)
    return x, adj, medoid


@pytest.mark.parametrize("metric,ksub,e,track", [
    ("l2", 16, 2, 256), ("ip", 16, 1, 0), ("l2", 256, 2, 256),
    ("ip", 256, 1, 128)])
def test_pq_kernel_equals_plain(dev, graph96, metric, ksub, e, track):
    """Narrow (4-bit, bf16 terms) and wide (8-bit, bf16 sum) paths on
    an odd batch of 77 (a short last group of qb=16) with `exclude`."""
    x, adj, medoid = graph96
    eng = tp.PqBeamEngine(x, adj, medoid, metric=metric, m=16, ksub=ksub,
                          kmeans_iters=4, device=dev)
    rng = np.random.default_rng(1)
    b = 77
    q = torch.from_numpy(x[rng.integers(0, len(x), b)] + np.float32(0.05)).to(dev)
    exc = torch.from_numpy(
        rng.integers(-1, len(x), b).astype(np.int32)).to(dev)
    kw = dict(eng.kernel_args(q, exc, 48), expansions=e, track_visited=track,
              max_iters=80)
    before = tp.pq_beam_search.launches
    got = tp.pq_beam_search(**kw)
    torch.cuda.synchronize()
    assert tp.pq_beam_search.launches == before + 1
    ref = tp.pq_beam_search_plain(**kw)
    assert len(got) == len(ref) == (3 if track else 2)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


@pytest.fixture(scope="module")
def pq_engines(graph96, dev):
    x, adj, medoid = graph96
    return {ksub: tp.PqBeamEngine(x, adj, medoid, metric="l2", m=16,
                                  ksub=ksub, kmeans_iters=4, device=dev)
            for ksub in (16, 256)}


def pq_equal(kw):
    """B3 against its plain version on the card, exactly (ids, scores,
    visited log), with one launch counted."""
    before = tp.pq_beam_search.launches
    got = tp.pq_beam_search(**kw)
    torch.cuda.synchronize()
    assert tp.pq_beam_search.launches == before + 1
    ref = tp.pq_beam_search_plain(**kw)
    assert len(got) == len(ref) == (3 if kw["track_visited"] else 2)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    return ref


@pytest.mark.parametrize("beam,ksub,e,track,ring", [
    (96, 256, 2, 256, 1024), (192, 16, 2, 0, 1024), (256, 256, 1, 256, 1024),
    (256, 16, 2, 256, 1), (512, 256, 2, 256, 1024), (512, 16, 1, 0, 1),
    (64, 256, 1, 0, 1)])
def test_pq_kernel_sort_widths(dev, graph96, pq_engines, beam, ksub, e,
                               track, ring):
    """Every sort width the network is built for up to P2 = 1024 (L=512):
    beams 96 and 192 (not powers of two), 256 with E 1 and 2, 512; ksub
    16 and 256; the minimum ring (ring_size 1, so V = P2) at P2 = 256,
    512 and 1024; the engine's own max_iters."""
    x = graph96[0]
    rng = np.random.default_rng(beam + ksub + e)
    b = 77
    q = torch.from_numpy(x[rng.integers(0, len(x), b)] + np.float32(0.05)).to(dev)
    exc = torch.from_numpy(
        rng.integers(-1, len(x), b).astype(np.int32)).to(dev)
    kw = dict(pq_engines[ksub].kernel_args(q, exc, beam), expansions=e,
              track_visited=track, ring_size=ring,
              max_iters=(4 * beam) // e + 32)
    assert tp._sizes(beam, e, ring, track)[1] in (256, 512, 1024)
    pq_equal(kw)


@pytest.mark.parametrize("ksub", [16, 256])
def test_pq_kernel_settle_on_duplicate_rows(dev, ksub):
    """Rows that appear two or three times give equal codes, so equal
    ADC scores: converged beams hold ties, and queries of one group of
    qb converge at different hops, so the settle pass applies many
    empty merges (pi^idle). One query's seeds are all -inf (it never
    expands: its beam takes the merges one by one) and another's half."""
    rng = np.random.default_rng(8)
    basis, _ = np.linalg.qr(rng.standard_normal((96, 16)))
    lat = (4.0 * rng.standard_normal((16, 16)))[rng.integers(0, 16, 900)]
    base = ((lat + rng.standard_normal((900, 16))) @ basis.T).astype(np.float32)
    x = np.concatenate([base, base, base[:400]])[rng.permutation(2200)]
    adj, medoid = build_vamana(x, graph_degree=48, complexity=64,
                               metric="l2", wave_size=1024, device=dev)
    eng = tp.PqBeamEngine(x, adj, medoid, metric="l2", m=16, ksub=ksub,
                          kmeans_iters=4, device=dev)
    b = 48
    q = torch.from_numpy(x[rng.integers(0, len(x), b)]
                         + np.float32(0.02)).to(dev)
    none = torch.full((b,), -1, dtype=torch.int32, device=dev)
    for qb, beam in ((4, 64), (16, 96)):
        kw = eng.kernel_args(q, none, beam)
        sc = kw["seed_scores"].clone()
        sc[5] = float("-inf")
        sc[6, ::2] = float("-inf")
        kw = dict(kw, seed_scores=sc, qb=qb,
                  track_visited=kw["max_iters"] * 2)
        ref = pq_equal(kw)
        ties = (ref[1][:, 1:] == ref[1][:, :-1]) & torch.isfinite(ref[1][:, 1:])
        assert bool(ties.any())
        # expansions per query: queries of a group converge apart
        done = (ref[2] != eng.n).sum(1).reshape(-1, qb)
        assert int((done.amax(1, keepdim=True) - done > 8).sum()) > 0
        assert int(done[5 // qb, 5 % qb]) == 0


@pytest.mark.parametrize("coarse", [0, 2])
def test_pq_kernel_equals_plain_m64_d768(dev, coarse):
    """m=64 at D=768 (a 64 KB LUT in shared memory, 7-plane records), and
    a residual case (mc=2 + mf=64 + 2 norm columns)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2000, 768)).astype(np.float32)
    adj, medoid = build_vamana(x, graph_degree=48, complexity=48,
                               metric="l2", wave_size=1024, device=dev)
    eng = tp.PqBeamEngine(x, adj, medoid, metric="l2", m=64, ksub=256,
                          coarse_m=coarse, kmeans_iters=3, device=dev)
    assert eng.records.shape[1] == (8 if coarse else 7)
    q = torch.from_numpy(x[:40] + np.float32(0.05)).to(dev)
    none = torch.full((40,), -1, dtype=torch.int32, device=dev)
    kw = eng.kernel_args(q, none, 64)
    got = tp.pq_beam_search(**kw)
    ref = tp.pq_beam_search_plain(**kw)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


def test_pq_engine_on_cuda_matches_cpu(dev, graph96):
    """PqBeamEngine on the card (kernel) vs on the CPU (plain), with the
    same codebooks and codes."""
    x, adj, medoid = graph96
    gpu = tp.PqBeamEngine(x, adj, medoid, metric="l2", m=16, ksub=256,
                          rescore="bf16", kmeans_iters=4, device=dev)
    cpu = tp.PqBeamEngine(x, adj, medoid, metric="l2", m=16, ksub=256,
                          rescore="bf16", codebooks=gpu.codebooks,
                          codes=gpu.codes, device="cpu")
    q = x[np.random.default_rng(2).integers(0, len(x), 40)] + np.float32(0.05)
    gi, gs = gpu.search(q, k=10, beam_width=64)
    ci, cs = cpu.search(q, k=10, beam_width=64)
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                       for a, b in zip(gi, ci)])
    assert overlap >= 0.98


def test_kernel_query_groups_on_duplicate_rows(dev):
    """B1 with qb=4 on a corpus whose rows appear two or three times:
    converged beams hold tied int8 scores, and the settle pass must
    reorder them as the group's empty merges do in the plain version;
    the ties send hops to the bitonic network (slow merges > 0)."""
    rng = np.random.default_rng(6)
    base = rng.standard_normal((800, 128)).astype(np.float32)
    x = np.concatenate([base, base, base[:400]])[rng.permutation(2000)]
    adj, medoid = build_vamana(x, graph_degree=24, complexity=48,
                               metric="l2", wave_size=1024, device=dev)
    st = tf.state_from_reference(x, adj, medoid, device=dev)
    b = 61
    q = torch.from_numpy(np.clip(np.round(
        x[rng.integers(0, len(x), b)] * 4), -6, 6)).to(dev)
    seeds = torch.full((b, 1), medoid, dtype=torch.int32, device=dev)
    sc = (2.0 * q @ st["corpus"][medoid] - st["sq_norms"][medoid])[:, None]
    exc = torch.full((b,), -1, dtype=torch.int32, device=dev)
    for qb in (4, 16):
        kw = dict(queries=q, blocks_i8=st["blocks"], meta_i32=st["meta"],
                  seed_ids=seeds, seed_scores=sc.contiguous(), exclude=exc,
                  r=adj.shape[1], beam_width=32, max_iters=100, metric="l2",
                  expansions=2, qb=qb, ring_size=256, track_visited=160)
        ref = tf.fused_beam_search_plain(**kw)
        ties = (ref[1][:, 1:] == ref[1][:, :-1]) & torch.isfinite(ref[1][:, 1:])
        assert bool(ties.any())
        slow, hops = kernel_equals_plain(kw)
        assert int(slow.sum()) > 0 and bool((slow <= hops).all())


def _bucket_case(dev, k, cap, d, b, p, seed):
    """Random bucket tables: int8 residuals, scales, |x|^2, ids with
    empty (-1) slots, centroids, bf16 rows; an odd batch whose first
    query probes one bucket p times."""
    g = torch.Generator().manual_seed(seed)
    pay = torch.randint(-127, 128, (k, cap, d), generator=g, dtype=torch.int8)
    scale = torch.rand((k, cap), generator=g) * 0.05
    cent = torch.randn((k, d), generator=g) * 3
    nsq = torch.rand((k, cap), generator=g) * 100
    ids = torch.arange(k * cap, dtype=torch.int32).reshape(k, cap)
    ids[torch.rand((k, cap), generator=g) < 0.2] = -1
    ids[:, cap - 3:] = -1
    vecs = (torch.randn((k, cap, d), generator=g) * 2).to(torch.bfloat16)
    q = torch.randn((b, d), generator=g) * 2
    probe = torch.randint(0, k, (b, p), generator=g, dtype=torch.int32)
    probe[0] = probe[0, 0]
    return [t.to(dev) for t in (q, probe, pay, scale, nsq, ids, cent, vecs)]


GRID = [(12, 50, 96, 13, 8), (9, 77, 128, 31, 5), (5, 40, 768, 7, 4),
        (6, 33, 24, 9, 3), (4, 20, 20, 5, 2)]


@pytest.mark.parametrize("k,cap,d,b,p", GRID)
def test_bucket_dots_kernel_matches_plain(dev, k, cap, d, b, p):
    """B4 on caps that are not multiples of 32, D of 96, 128 and 768 (16-byte
    loads) and 24 / 20 (single elements), an odd batch, a repeated probe."""
    q, probe, *_, vecs = _bucket_case(dev, k, cap, d, b, p, seed=d + cap)
    before = tbk.ivf_bucket_dots.launches
    got = tbk.ivf_bucket_dots(q, probe, vecs)
    torch.cuda.synchronize()
    assert tbk.ivf_bucket_dots.launches == before + 1
    ref = tbk.ivf_bucket_dots_plain(q, probe, vecs)
    tol = 1e-5 * float(q.norm(dim=1).max() * vecs.float().norm(dim=2).max())
    torch.testing.assert_close(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("k,cap,d,b,p", GRID)
def test_ivf8_kernel_matches_plain(dev, metric, k, cap, d, b, p):
    """B2 on the same grid, l2 and ip, with empty (-1) slots."""
    q, probe, pay, scale, nsq, ids, cent, _ = _bucket_case(
        dev, k, cap, d, b, p, seed=d + cap + 1)
    before = tbk.ivf8_bucket_scores.launches
    got = tbk.ivf8_bucket_scores(q, probe, pay, scale, nsq, ids, cent, metric)
    torch.cuda.synchronize()
    assert tbk.ivf8_bucket_scores.launches == before + 1
    ref = tbk.ivf8_bucket_scores_plain(q, probe, pay, scale, nsq, ids, cent,
                                       metric)
    assert torch.equal(torch.isneginf(got), torch.isneginf(ref))
    assert bool(torch.isfinite(got[~torch.isneginf(got)]).all())
    row = (cent.norm(dim=1)[:, None] + scale * pay.float().norm(dim=2)).max()
    tol = 1e-5 * float(q.norm(dim=1).max() * row) * (2 if metric == "l2" else 1)
    live = torch.isfinite(ref)
    torch.testing.assert_close(got[live], ref[live], rtol=0, atol=tol)


def _bucket_tables(dev, k, cap, d, seed, offset=0):
    """Random B2 and B4 tables; with `offset`, each table is a view that
    starts `offset` elements into a larger buffer (not 16-byte aligned)."""
    g = torch.Generator().manual_seed(seed)
    pay = torch.randint(-127, 128, (k * cap * d + offset,), generator=g,
                        dtype=torch.int8)[offset:].view(k, cap, d)
    vecs = (torch.randn((k * cap * d + offset,), generator=g) * 2).to(
        torch.bfloat16)[offset:].view(k, cap, d)
    scale = torch.rand((k, cap), generator=g) * 0.05
    nsq = torch.rand((k, cap), generator=g) * 100
    ids = torch.arange(k * cap, dtype=torch.int32).reshape(k, cap)
    ids[torch.rand((k, cap), generator=g) < 0.2] = -1
    cent = torch.randn((k, d), generator=g) * 3
    if offset:   # keep the views' offsets on the card
        pay = torch.empty(k * cap * d + offset, dtype=torch.int8,
                          device=dev)[offset:].view(k, cap, d).copy_(pay)
        vecs = torch.empty(k * cap * d + offset, dtype=torch.bfloat16,
                           device=dev)[offset:].view(k, cap, d).copy_(vecs)
    return {"dots": (vecs.to(dev),),
            "ivf8": tuple(t.to(dev) for t in (pay, scale, nsq, ids, cent))}


def _bucket_kernel_check(kind, q, probe, tables, metric="l2"):
    """One kernel call against its plain version: launches + 1, NaN rows
    exactly at probes outside [0, K), -inf positions equal, finite scores
    within 1e-5 x |q| x (largest row norm) (l2: twice that), and a repeat
    with the same bits. Returns the output."""
    k = tables[0].shape[0]
    fn = tbk.ivf_bucket_dots if kind == "dots" else tbk.ivf8_bucket_scores
    plain = (tbk.ivf_bucket_dots_plain if kind == "dots"
             else tbk.ivf8_bucket_scores_plain)
    extra = () if kind == "dots" else (metric,)
    before = fn.launches
    got = fn(q, probe, *tables, *extra)
    again = fn(q, probe, *tables, *extra)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    oor = (probe < 0) | (probe >= k)
    ref = plain(q, torch.where(oor, 0, probe), *tables, *extra)
    rows = oor.t() if kind == "dots" else oor        # [P, B] / [B, P]
    nan = torch.isnan(got)
    assert torch.equal(nan, rows[..., None].expand_as(got))
    assert torch.equal(torch.isnan(again), nan)
    assert torch.equal(got[~nan], again[~nan])       # the same bits
    got, ref = got[~nan], ref[~rows[..., None].expand_as(ref)]
    assert torch.equal(torch.isneginf(got), torch.isneginf(ref))
    assert bool(torch.isfinite(got[~torch.isneginf(got)]).all())
    if kind == "dots":
        row = tables[0].float().norm(dim=2).max()
    else:
        pay, scale, _, _, cent = tables
        row = (cent.norm(dim=1)[:, None] + scale * pay.float().norm(dim=2)).max()
    tol = 1e-5 * float(q.norm(dim=1).max() * row) * (
        2 if kind == "ivf8" and metric == "l2" else 1)
    live = torch.isfinite(ref)
    torch.testing.assert_close(got[live], ref[live], rtol=0, atol=tol)
    return got


@pytest.mark.parametrize("kind", ["dots", "ivf8"])
@pytest.mark.parametrize("case", ["all_on_one", "half_on_one",
                                  "duplicates_in_rows"])
def test_bucket_kernels_hot_buckets(dev, kind, case):
    """B2 and B4 at a serving batch (B = 2048, P = 8) where every query
    probes one bucket, where half of them do, and where rows repeat a
    bucket: a hot bucket is cut into many work items, each read of it
    serves up to qmax pairs."""
    k, cap, d = 40, 130, 96 if kind == "ivf8" else 128
    tables = _bucket_tables(dev, k, cap, d, seed=11)[kind]
    g = torch.Generator().manual_seed(12)
    q = (torch.randn((2048, d), generator=g) * 2).to(dev)
    probe = torch.randint(0, k, (2048, 8), generator=g, dtype=torch.int32)
    if case == "all_on_one":
        probe[:, 3] = 7
    elif case == "half_on_one":
        probe[::2, 0] = 5
    else:
        probe[:, 4:] = probe[:, :1]
    _bucket_kernel_check(kind, q, probe.to(dev), tables)


@pytest.mark.parametrize("kind", ["dots", "ivf8"])
def test_bucket_kernels_out_of_range_probes(dev, kind):
    """Probes outside [0, K) (negative and >= K, one whole row of them)
    give NaN rows exactly there and leave every other row as it was."""
    k, cap, d = 9, 77, 96
    tables = _bucket_tables(dev, k, cap, d, seed=13)[kind]
    g = torch.Generator().manual_seed(14)
    q = (torch.randn((31, d), generator=g) * 2).to(dev)
    probe = torch.randint(0, k, (31, 5), generator=g, dtype=torch.int32)
    probe[3, 1], probe[7, 4], probe[8] = -1, k, k + 5
    _bucket_kernel_check(kind, q, probe.to(dev), tables)


@pytest.mark.parametrize("kind", ["dots", "ivf8"])
@pytest.mark.parametrize("d,cap,offset", [
    (20, 33, 0), (24, 50, 0), (96, 77, 0), (128, 130, 0), (768, 40, 0),
    (96, 77, 3), (128, 50, 1)])
def test_bucket_kernels_widths_and_alignment(dev, kind, d, cap, offset):
    """D of 20 and 24 (no 16-byte copies for int8; D % 32 != 0), 96, 128
    and 768 (several column steps per tile), caps that are not multiples
    of 16, and table views that are not 16-byte aligned (the kernel takes
    its single-element copies)."""
    k = 6
    tables = _bucket_tables(dev, k, cap, d, seed=d + cap, offset=offset)[kind]
    assert offset == 0 or tables[0].data_ptr() % 16
    g = torch.Generator().manual_seed(15)
    q = (torch.randn((37, d), generator=g) * 2).to(dev)
    probe = torch.randint(0, k, (37, 4), generator=g, dtype=torch.int32)
    for metric in (("l2", "ip") if kind == "ivf8" else ("ip",)):
        _bucket_kernel_check(kind, q, probe.to(dev), tables, metric)


@pytest.mark.parametrize("kind", ["dots", "ivf8"])
def test_bucket_kernels_do_not_synchronize(dev, kind):
    """A wrapper call (the probes' sort, the work list and the scan) runs
    under torch.cuda.set_sync_debug_mode("error"): nothing reads back to
    the host."""
    tables = _bucket_tables(dev, 20, 64, 96, seed=16)[kind]
    q = torch.randn((256, 96), device=dev)
    probe = torch.randint(0, 20, (256, 8), device=dev, dtype=torch.int32)
    fn = tbk.ivf_bucket_dots if kind == "dots" else tbk.ivf8_bucket_scores
    extra = () if kind == "dots" else ("l2",)
    fn(q, probe, *tables, *extra)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(q, probe, *tables, *extra)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("k,cap,d,b,p", GRID)
def test_bucket_kernels_match_earlier_design(dev, k, cap, d, b, p):
    """The bucket-major kernels against their earlier designs (one CTA
    per (query, probe), `csrc/*_pairs.cu`) on the smoke's grid: within
    the same tolerance as the plain versions."""
    from leann_tpu_torch.evals.bucket_scan_cycles import earlier

    q, probe, pay, scale, nsq, ids, cent, vecs = _bucket_case(
        dev, k, cap, d, b, p, seed=d + cap + 2)
    tol = 1e-5 * float(q.norm(dim=1).max() * vecs.float().norm(dim=2).max())
    torch.testing.assert_close(
        tbk.ivf_bucket_dots(q, probe, vecs),
        earlier(torch, "dots", (q, probe, vecs), "ip"),
        rtol=0, atol=tol)
    args = (q, probe, pay, scale, nsq, ids, cent)
    row = (cent.norm(dim=1)[:, None] + scale * pay.float().norm(dim=2)).max()
    got = tbk.ivf8_bucket_scores(*args, "l2")
    old = earlier(torch, "ivf8", args, "l2")
    assert torch.equal(torch.isneginf(got), torch.isneginf(old))
    live = torch.isfinite(old)
    torch.testing.assert_close(
        got[live], old[live], rtol=0,
        atol=2e-5 * float(q.norm(dim=1).max() * row))


@pytest.mark.parametrize("k,b,p,qmax", [(7479, 2048, 8, 32), (40, 2048, 8, 32),
                                        (9, 31, 5, 16), (3, 1, 1, 8)])
def test_bucket_items_on_the_card_equal_worklist(dev, k, b, p, qmax):
    """The work list's items built on the card in one launch equal
    `bucket_worklist`'s, with a hot bucket and out-of-range probes."""
    import ctypes

    from leann_tpu_torch.ops import _cuda

    g = torch.Generator().manual_seed(k + b)
    probe = torch.randint(0, k, (b, p), generator=g, dtype=torch.int32)
    probe[: b // 2, 0] = k - 1
    probe[0, -1], probe[-1, 0] = -1, k + 2
    probe = probe.to(dev)
    pairs, want = tbk.bucket_worklist(probe, k, qmax)
    skey, pairs2 = tbk._sorted_keys(probe, k)
    assert torch.equal(pairs, pairs2)
    n_items = tbk._n_items(b * p, k, qmax)
    scratch = torch.empty(k + 2 + 3 * n_items, dtype=torch.int32, device=dev)
    for name in ("ivf_bucket_dots", "ivf8_scan"):
        lib = _cuda.load(name)
        scratch.fill_(-9)
        err = lib.leann_bucket_items(
            skey.data_ptr(), b * p, k, qmax, n_items, scratch.data_ptr(),
            scratch[k + 2:].data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        _cuda.check(lib, err, "leann_bucket_items")
        torch.cuda.synchronize()
        assert torch.equal(scratch[k + 2:].view(n_items, 3), want)


def test_kmeans_is_deterministic_on_the_card(dev):
    """Two k-means runs on one corpus give byte-equal centers and
    assignment (the sums run in a fixed order), and PyTorch's
    deterministic mode is left as it was."""
    from leann_tpu_torch.ops.ivf import kmeans

    rng = np.random.default_rng(10)
    c = rng.standard_normal((64, 64)).astype(np.float32) * 4
    x = c[rng.integers(0, 64, 200_000)] + rng.standard_normal(
        (200_000, 64)).astype(np.float32)
    was = torch.are_deterministic_algorithms_enabled()
    a = kmeans(x, 256, iters=4, metric="l2", device=dev)
    b = kmeans(x, 256, iters=4, metric="l2", device=dev)
    assert a[0].tobytes() == b[0].tobytes()
    assert a[1].tobytes() == b[1].tobytes()
    assert torch.are_deterministic_algorithms_enabled() == was


def test_ivf_engines_on_cuda_match_cpu(dev, monkeypatch):
    """IvfEngine.search_pallas (B4) and IvfInt8Engine under
    LEANN_IVF8_PALLAS=1 (B2) on the card against the same engines on the
    CPU (plain versions), same centers."""
    from leann_tpu_torch.ops.ivf import IvfEngine
    from leann_tpu_torch.ops.ivf_int8 import IvfInt8Engine

    rng = np.random.default_rng(8)
    c = rng.standard_normal((40, 96)).astype(np.float32) * 4
    x = (c[rng.integers(0, 40, 6000)]
         + rng.standard_normal((6000, 96)).astype(np.float32))
    q = x[rng.integers(0, 6000, 33)] + np.float32(0.05)
    monkeypatch.setenv("LEANN_IVF8_PALLAS", "1")
    for cls in (IvfEngine, IvfInt8Engine):
        gpu = cls(x, n_clusters=64, metric="l2", device=dev)
        cpu = cls(x, metric="l2", centers=gpu.centers, assign=gpu.assign,
                  device="cpu")
        search = "search_pallas" if cls is IvfEngine else "search"
        gi, gs = getattr(gpu, search)(q, k=10, nprobe=8)
        ci, cs = getattr(cpu, search)(q, k=10, nprobe=8)
        overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                           for a, b in zip(gi, ci)])
        assert overlap >= 0.99
        same = gi == ci
        np.testing.assert_allclose(gs[same], cs[same], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,b,d,r", [
    (5000, 17, 96, 48), (5000, 16, 128, 128), (3000, 9, 64, 7),
    (2000, 5, 50, 200), (1000, 1, 130, 3), (4000, 33, 100, 48)])
def test_gather_score_kernel_matches_plain(dev, n, b, d, r):
    """B5 on D with 16-byte loads (96, 128, 64), 4-byte loads (100) and
    single bytes (50, 130), R of 7 to 200, odd batches, duplicate ids and
    the rows 0 and N-1."""
    g = torch.Generator().manual_seed(n + d + r)
    corpus = torch.randint(-128, 128, (n, d), generator=g, dtype=torch.int8)
    ids = torch.randint(0, n, (b, r), generator=g, dtype=torch.int32)
    ids[:, 0], ids[:, 1] = n - 1, 0
    ids[b // 2, :] = 7
    q = torch.randn((b, d), generator=g)
    corpus, ids, q = corpus.to(dev), ids.to(dev), q.to(dev)
    before = tgs.gather_score.launches
    got = tgs.gather_score(corpus, ids, q)
    torch.cuda.synchronize()
    assert tgs.gather_score.launches == before + 1
    ref = tgs.gather_score_plain(corpus, ids, q)
    tol = 1e-5 * float(q.norm(dim=1).max()
                       * corpus[ids.long()].float().norm(dim=2).max())
    torch.testing.assert_close(got, ref, rtol=0, atol=tol)
    assert float(got[b // 2].max() - got[b // 2].min()) == 0.0
    # int64 ids, and a corpus view that is only 4-byte aligned
    torch.testing.assert_close(
        tgs.gather_score(corpus, ids.long(), q), got, rtol=0, atol=0)
    if d % 16 == 0:
        shifted = torch.empty(n * d + 4, dtype=torch.int8, device=dev)[4:]
        shifted = shifted.view(n, d).copy_(corpus)
        torch.testing.assert_close(
            tgs.gather_score(shifted, ids, q), ref, rtol=0, atol=tol)


def test_ivf_pq_engine_on_cuda_matches_cpu(dev):
    """IvfPqEngine on the card against the same tables on the CPU: no
    kernel launches on this path, the ids agree."""
    from leann_tpu_torch.ops import ivf_pq

    rng = np.random.default_rng(9)
    c = rng.standard_normal((40, 96)).astype(np.float32) * 4
    x = (c[rng.integers(0, 40, 6000)]
         + rng.standard_normal((6000, 96)).astype(np.float32))
    q = x[rng.integers(0, 6000, 33)] + np.float32(0.05)
    counts = [w.launches for w in (tf.fused_beam_search, tp.pq_beam_search,
                                   tbk.ivf_bucket_dots, tbk.ivf8_bucket_scores,
                                   tgs.gather_score)]
    gpu = ivf_pq.IvfPqEngine(x, n_clusters=64, metric="l2", m=16, device=dev)
    host = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in vars(gpu).items()}
    cpu = ivf_pq.state_from_reference(
        dict(host, metric="l2", corpus=gpu.corpus.cpu().numpy()),
        device="cpu")
    gi, gs = gpu.search(q, k=10, nprobe=8)
    ci, cs = cpu.search(q, k=10, nprobe=8)
    assert counts == [w.launches for w in (
        tf.fused_beam_search, tp.pq_beam_search, tbk.ivf_bucket_dots,
        tbk.ivf8_bucket_scores, tgs.gather_score)]
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                       for a, b in zip(gi, ci)])
    assert overlap >= 0.99
    same = gi == ci
    np.testing.assert_allclose(gs[same], cs[same], rtol=1e-5, atol=1e-4)


def test_bert_forward_on_cuda_matches_cpu(dev):
    """The encoder on the card against the CPU: float32 within 1e-5, the
    bf16 products (float32 result) within 2e-3 and cosine >= 0.999."""
    from leann_tpu_torch.models import bert

    texts = [f"passage {i} " + "w " * (i % 9) for i in range(20)]
    for dtype, atol in (("float32", 1e-5), ("bfloat16", 2e-3)):
        gpu = bert.BertEncoder(config=bert.BertConfig.tiny(),
                               compute_dtype=dtype, device=dev)
        cpu = bert.BertEncoder(config=bert.BertConfig.tiny(),
                               compute_dtype=dtype, device="cpu")
        a, b = gpu.embed(texts, batch_size=8), cpu.embed(texts, batch_size=8)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
        assert ((a * b).sum(1) > 0.999).all()
