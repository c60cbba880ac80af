"""Tests of the port's CUDA kernels: they need a card and skip without
one. This file imports neither JAX nor `leann_tpu`, so on a machine with
a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the traversal kernels (B1, B3) exactly: the plain versions
sum in the kernels' order, so ids, scores and visited logs are equal.
The bucket kernels (B2, B4): -inf positions equal exactly, finite scores
within 1e-5 x |q| x (largest row norm) (l2: twice that), since their
plain versions add the same exact products in another order. The row
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


@pytest.mark.parametrize("metric,expansions,track", [
    ("l2", 2, 160), ("l2", 1, 0), ("ip", 2, 0), ("ip", 1, 160)])
def test_kernel_equals_plain(dev, graph, metric, expansions, track):
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
    kw = dict(r=adj.shape[1], beam_width=48, max_iters=120, metric=metric,
              expansions=expansions, ring_size=512, track_visited=track)
    before = tf.fused_beam_search.launches
    got = tf.fused_beam_search(q, st["blocks"], st["meta"], seeds, sc, exc,
                               **kw)
    torch.cuda.synchronize()
    assert tf.fused_beam_search.launches == before + 1
    ref = tf.fused_beam_search_plain(q, st["blocks"], st["meta"], seeds, sc,
                                     exc, **kw)
    assert len(got) == len(ref) == (3 if track else 2)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


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
    got = tf.fused_beam_search(**kw)
    ref = tf.fused_beam_search_plain(**kw)
    assert len(got) == len(ref) == 3
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


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
    reorder them as the group's empty merges do in the plain version."""
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
        kw = dict(r=adj.shape[1], beam_width=32, max_iters=100, metric="l2",
                  expansions=2, qb=qb, ring_size=256, track_visited=160)
        got = tf.fused_beam_search(q, st["blocks"], st["meta"], seeds,
                                   sc.contiguous(), exc, **kw)
        ref = tf.fused_beam_search_plain(q, st["blocks"], st["meta"], seeds,
                                         sc.contiguous(), exc, **kw)
        ties = (ref[1][:, 1:] == ref[1][:, :-1]) & torch.isfinite(ref[1][:, 1:])
        assert bool(ties.any())
        for a, r in zip(got, ref):
            assert torch.equal(a, r)


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
