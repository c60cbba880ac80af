"""Parity of the port's Vamana builder (`leann_tpu_torch/ops/vamana.py`)
with the JAX reference (`leann_tpu/ops/vamana.py`), on CPU.

Graphs are not compared bit for bit (float ties and the order of
reverse-edge scatters differ); a port graph must search as well as the
reference graph built on the same corpus and seed: recall@10 within 0.02,
both searched by the same engine. Robust prune rows are compared
directly: equal on >= 99% of positions at precision "highest"."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from leann_tpu.ops import vamana as jv
from leann_tpu.ops.distance import exact_topk
from leann_tpu_torch.ops import vamana as tv
from leann_tpu_torch.ops.beam import BeamSearchEngine

# the suite runs in several worker processes that share the CPUs: one
# intra-op thread each keeps PyTorch's many small ops from oversubscribing
torch.set_num_threads(1)


def _clustered(n, d, seed, clusters=16):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((clusters, d)).astype(np.float32) * 3
    return (c[rng.integers(0, clusters, n)]
            + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def _recall(adj, medoid, x, q, metric):
    eng = BeamSearchEngine(x, adj, medoid, metric=metric, block_mode="none",
                           device="cpu")
    idx, _ = eng.search(q, k=10, beam_width=32)
    _, oracle = exact_topk(q, x, 10, metric=metric)
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                    for a, b in zip(idx, oracle)])


def test_robust_prune_matches_reference():
    rng = np.random.default_rng(0)
    w, c, d, n = 48, 40, 16, 1000
    ids = rng.integers(0, n + 1, (w, c)).astype(np.int32)   # n = sentinel
    ids[:, 5] = ids[:, 2]                                   # duplicates
    vecs = rng.standard_normal((w, c, d)).astype(np.float32)
    pts = rng.standard_normal((w, d)).astype(np.float32)
    for alpha in (1.0, 1.2):
        want = np.asarray(jv.robust_prune_batch(
            jnp.asarray(pts), jnp.asarray(ids), jnp.asarray(vecs),
            jnp.int32(n), jnp.float32(alpha), 12, precision="highest"))
        got = tv.robust_prune_batch(
            torch.from_numpy(pts), torch.from_numpy(ids),
            torch.from_numpy(vecs), n, alpha, 12, precision="highest").numpy()
        assert (got == want).mean() >= 0.99


def test_robust_prune_occlusion():
    p = torch.zeros((1, 1))
    ids = torch.tensor([[0, 1, 2]])
    vecs = torch.tensor([[[1.0], [2.0], [10.0]]])
    out = tv.robust_prune_batch(p, ids, vecs, 99, 1.3, 3)[0].tolist()
    assert out[0] == 0 and 1 not in out and 2 in out
    out1 = tv.robust_prune_batch(p, ids, vecs, 99, 1.0, 3)[0].tolist()
    assert out1[0] == 0 and set(out1[1:]) == {99}


BUILD_KW = dict(graph_degree=12, complexity=24, alpha=1.2, metric="l2",
                wave_size=128, seed=0)


@pytest.fixture(scope="module")
def reference_graph():
    """The reference's graph (its CPU build engine) on a 500 x 128
    corpus, built once for both engine cases."""
    x = _clustered(500, 128, seed=4)
    saved = os.environ.pop("LEANN_BUILD_ENGINE", None)
    try:
        adj, med = jv.build_vamana(x, **BUILD_KW)
    finally:
        if saved is not None:
            os.environ["LEANN_BUILD_ENGINE"] = saved
    return x, adj, med


@pytest.mark.parametrize("engine", ["row-gather", "fused"])
def test_build_recall_matches_reference(engine, reference_graph, monkeypatch):
    """Both wave engines (row-gather beam search; the fused traversal on
    its plain version) build graphs that search within 0.02 recall@10 of
    the reference's graph."""
    x, j_adj, j_med = reference_graph
    n, d = x.shape
    rng = np.random.default_rng(5)
    q = x[rng.integers(0, n, 24)] + 0.05 * rng.standard_normal(
        (24, d)).astype(np.float32)
    monkeypatch.setenv("LEANN_BUILD_ENGINE",
                       "fused" if engine == "fused" else "xla")
    t_adj, t_med = tv.build_vamana(x, device="cpu", **BUILD_KW)
    assert t_adj.shape == (n, 12) and t_adj.dtype == np.int32
    assert t_med == j_med
    assert ((t_adj >= 0) & (t_adj <= n)).all()
    assert (t_adj == np.arange(n)[:, None]).sum() == 0
    rec_j = _recall(j_adj, j_med, x, q, "l2")
    rec_t = _recall(t_adj, t_med, x, q, "l2")
    assert rec_t >= rec_j - 0.02, (rec_t, rec_j)


@pytest.mark.parametrize("metric", ["ip", "cosine"])
def test_build_recall_other_metrics(metric):
    x = _clustered(800, 24, seed=6)
    x = x / np.linalg.norm(x, axis=1, keepdims=True)
    adj, med = tv.build_vamana(x, graph_degree=16, complexity=32,
                               metric=metric, wave_size=256, device="cpu")
    rng = np.random.default_rng(7)
    q = x[rng.integers(0, 800, 24)] + 0.01 * rng.standard_normal(
        (24, 24)).astype(np.float32)
    assert _recall(adj, med, x, q, metric) >= 0.9


def test_checkpoint_resume_and_watchdog(tmp_path, monkeypatch):
    """A build killed mid-pass resumes from its wave snapshot; the
    watchdog is disarmed when a build raises, and re-reads its stall
    threshold on every arm."""
    x = _clustered(600, 16, seed=8)
    ckpt = str(tmp_path / "build.ckpt")
    kw = dict(graph_degree=12, complexity=24, metric="l2", wave_size=128,
              seed=0, checkpoint_path=ckpt, checkpoint_every=2,
              device="cpu")
    monkeypatch.setenv("LEANN_BUILD_ABORT_AFTER", "3")
    monkeypatch.setenv("LEANN_BUILD_STALL_S", "3600")
    with pytest.raises(tv.BuildAborted):
        tv.build_vamana(x, **kw)
    assert os.path.exists(ckpt)
    assert tv._WATCHDOG["active"] is False
    assert tv._WATCHDOG["stall_s"] == 3600
    monkeypatch.delenv("LEANN_BUILD_ABORT_AFTER")
    monkeypatch.setenv("LEANN_BUILD_STALL_S", "1800")
    adj, med = tv.build_vamana(x, **kw)                 # resumes
    assert tv._WATCHDOG["stall_s"] == 1800
    assert tv._WATCHDOG["active"] is False
    assert adj.shape == (600, 12)
    rng = np.random.default_rng(9)
    q = x[rng.integers(0, 600, 16)] + np.float32(0.01)
    assert _recall(adj, med, x, q, "l2") >= 0.85


def test_insert_points_extends_graph():
    x = _clustered(700, 16, seed=10)
    adj, med = tv.build_vamana(x[:500], graph_degree=12, complexity=24,
                               metric="l2", wave_size=256, device="cpu")
    full = np.concatenate([adj, np.zeros((200, 12), np.int32)])
    full = np.where(full == 500, 700, full)             # new sentinel
    new = tv.insert_points(x, full, med, np.arange(500, 700),
                           graph_degree=12, complexity=24, metric="l2",
                           wave_size=128, device="cpu")
    assert new.shape == (700, 12)
    assert (new[500:] == np.arange(500, 700)[:, None]).sum() == 0
    assert _recall(new, med, x, x[500:532], "l2") >= 0.9
