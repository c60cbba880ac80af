"""Tests of the port's CUDA kernels: they need a card and skip without
one. This file imports neither JAX nor `leann_tpu`, so on a machine with
a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: exact. The plain version sums in the kernel's order, so the
kernel's ids, scores and visited log equal the plain version's."""

import numpy as np
import pytest
import torch

from leann_tpu_torch.ops import fused_beam as tf
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
