"""The port's IVF-Flat engine (`leann_tpu_torch/ops/ivf.py`, the torch
bucket scan that `IvfSearcher` serves) against the plain IVF reference
(`tests/plain_ivf.py`, which imports neither package), on the CPU.

On seeded random data (n = 3000, D = 32, 24 lists, nprobe 4, l2 and ip)
`IvfEngine.search_many_device` must give the reference's ids on at least
99.9% of the (row, rank) slots and scores within 1e-6 of the scale of
their float32 score's terms (2|q||x| + |x|^2, or |q||x| for ip): the
engine rescores its C candidates in float32, so only the order of the
sums differs, and the bf16 stage 1 keeps C = 4k candidates, far more
than rounding moves. The same holds with spill buckets (a small cap), an
empty cluster, and k beyond the probed buckets' live rows. With the last
probe dropped the comparison fails. The benchmark's plain reference
(`benchmark/reference/ivf.py`) agrees with this one."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_ivf
from benchmark import ivf_faults
from benchmark.reference import ivf as bench_ivf
from leann_tpu_torch.ops import ivf

torch.set_num_threads(1)

N, D, K, NPROBE = 3000, 32, 24, 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(22)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((4, 256, D)).astype(np.float32)
    return x, torch.from_numpy(q)


@pytest.fixture(scope="module")
def engines(data):
    x, _ = data
    return {m: ivf.IvfEngine(x, n_clusters=K, metric=m, device="cpu")
            for m in ("l2", "ip")}


def _run(eng, x, qs, metric, k=10, nprobe=NPROBE, cap=None):
    """The engine's and the reference's (ids, scores), [B, k] each."""
    ids, sc = eng.search_many_device(qs, k=k, nprobe=nprobe,
                                     rescore_factor=4)
    rid, rsc, _ = plain_ivf.search(qs.reshape(-1, D), x, eng.centers,
                                   eng.assign, k, nprobe, metric, cap)
    return ids.reshape(-1, k), sc.reshape(-1, k), rid, rsc


def _score_gap(q, x, ids, sc, metric):
    """The widest gap between a returned score and the float32 score of
    its id, over the scale of its terms (live slots only)."""
    xt = torch.from_numpy(x)
    live = ids >= 0
    rows = xt[ids.clamp_min(0)]                              # [B, k, D]
    ref = torch.stack([plain_ivf.scores(qi, r, metric)
                       for qi, r in zip(q, rows)])
    qn = torch.linalg.vector_norm(q, dim=1)[:, None]
    xn = torch.linalg.vector_norm(rows, dim=2)
    scale = 2 * qn * xn + xn * xn if metric == "l2" else qn * xn
    gap = (sc - ref).abs() / scale
    return float(torch.where(live, gap, torch.zeros_like(gap)).max())


def _assert_agree(eng, x, qs, metric, **kw):
    ids, sc, rid, rsc = _run(eng, x, qs, metric, **kw)
    assert (ids == rid).float().mean() >= 0.999
    assert _score_gap(qs.reshape(-1, D), x, ids, sc, metric) <= 1e-6
    assert torch.equal(ids == -1, rid == -1)
    assert bool(torch.isneginf(sc[ids == -1]).all())
    return ids


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_engine_agrees_with_the_plain_reference(data, engines, metric):
    x, qs = data
    _assert_agree(engines[metric], x, qs, metric)


def test_spill_buckets_agree(data):
    x, qs = data
    eng = ivf.IvfEngine(x, n_clusters=K, metric="l2", cap=16, device="cpu")
    assert eng.bucket_ids.shape[0] >= 4 * K        # most clusters spill
    _assert_agree(eng, x, qs, "l2", cap=16)


def test_an_empty_cluster_agrees(data, engines):
    """A last centre equal to the first with no rows: its one empty
    bucket ties with cluster 0's, comes after them, and is probed."""
    x, qs = data
    base = engines["l2"]
    centers = np.concatenate([base.centers, base.centers[:1]])
    eng = ivf.IvfEngine(x, metric="l2", centers=centers, assign=base.assign,
                        device="cpu")
    empty = eng.bucket_ids.shape[0] - 1
    assert bool((eng.bucket_ids[empty] == N).all())
    _, blist = plain_ivf.bucket_list(base.assign, K + 1)
    probed = [plain_ivf.probes(q, centers, blist, NPROBE, "l2")
              for q in qs.reshape(-1, D)]
    assert any(empty in p for p in probed)
    _assert_agree(eng, x, qs, "l2")


def test_k_beyond_the_live_rows(data):
    """One probe of buckets of 8 rows and k = 12: the last slots are
    empty (-1, -inf) on both sides."""
    x, qs = data
    eng = ivf.IvfEngine(x, n_clusters=K, metric="l2", cap=8, device="cpu")
    ids = _assert_agree(eng, x, qs[:1], "l2", k=12, nprobe=1, cap=8)
    assert bool((ids[:, 8:] == -1).all())


def test_a_dropped_last_probe_fails_the_comparison(data, engines):
    x, qs = data
    with ivf_faults.ivf_last_probe_dropped():
        ids, _, rid, _ = _run(engines["l2"], x, qs, "l2")
    assert (ids == rid).float().mean() < 0.999


@pytest.fixture()
def totals():
    """`ivf_search`'s totals set to zero for the test, restored after."""
    saved = (ivf.ivf_search.rows, ivf.ivf_search.traced_queries)
    ivf.ivf_search.rows = ivf.ivf_search.traced_queries = 0
    yield ivf.ivf_search
    ivf.ivf_search.rows, ivf.ivf_search.traced_queries = saved


def test_rows_counted_only_while_tracing(data, engines, totals):
    x, qs = data
    eng = engines["ip"]
    eng.search_many_device(qs, k=10, nprobe=NPROBE)
    assert totals.rows == 0 and totals.traced_queries == 0
    with profile(activities=[ProfilerActivity.CPU]):
        eng.search_many_device(qs, k=10, nprobe=NPROBE)
    _, _, live = plain_ivf.search(qs.reshape(-1, D), x, eng.centers,
                                  eng.assign, 10, NPROBE, "ip")
    assert int(totals.rows) == live
    assert totals.traced_queries == qs.shape[0] * qs.shape[1]
    eng.search_many_device(qs, k=10, nprobe=NPROBE)
    assert int(totals.rows) == live


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cpu_batches_never_capture(data, engines, metric):
    """A CPU engine's `search_many_device` runs every batch eagerly, call
    after call of one shape (its path counter shows only `eager`), with
    the answers of `search_device` batch by batch."""
    _, qs = data
    eng = engines[metric]
    many = ivf.IvfEngine.search_many_device
    paths = dict(many.paths)
    want = [eng.search_device(q, k=10, nprobe=NPROBE) for q in qs]
    for _ in range(3):
        ids, sc = eng.search_many_device(qs, k=10, nprobe=NPROBE)
        assert torch.equal(ids, torch.stack([w[0] for w in want]))
        assert torch.equal(sc, torch.stack([w[1] for w in want]))
    got = {k: v - paths[k] for k, v in many.paths.items()}
    assert got == {"eager": 3 * qs.shape[0], "capture": 0, "replay": 0}
    assert not eng._graphs


@pytest.mark.parametrize("cap", [None, 16])
def test_the_two_plain_references_agree(data, engines, cap):
    x, qs = data
    eng = engines["l2"]
    q = qs.reshape(-1, D)
    rid, _, live = plain_ivf.search(q, x, eng.centers, eng.assign, 10,
                                    NPROBE, "l2", cap)
    bid, _ = bench_ivf.topk(q, torch.from_numpy(x), eng.centers, eng.assign,
                            10, NPROBE, "l2", cap=cap, rows=100)
    assert (rid == bid).float().mean() >= 0.999
    got_cap, cluster, members = bench_ivf.buckets(eng.assign, K, cap)
    want_cap, blist = plain_ivf.bucket_list(eng.assign, K, cap)
    assert got_cap == want_cap
    assert cluster.tolist() == [c for c, _ in blist]
    assert [[r for r in row if r >= 0] for row in members.tolist()] == \
        [rows for _, rows in blist]
    cent = torch.from_numpy(eng.centers)
    lo, hi, _ = bench_ivf.live_rows_range(q, cent, cluster, members, NPROBE,
                                          "l2", tie=0.0)
    assert lo <= live <= hi
    if cap is None:                 # no spill buckets: no exact ties
        assert lo == live == hi
    wide = bench_ivf.live_rows_range(q, cent, cluster, members, NPROBE,
                                     "l2")
    assert wide[0] <= lo and wide[1] >= hi


def test_live_rows_range_lets_a_tie_at_the_last_probe_go_either_way():
    """Buckets 0-2 of 5, 7 and 3 rows, one query: bucket 1's centre
    ties with bucket 2's, the second probe may take either."""
    members = torch.full((3, 8), -1)
    for b, n in enumerate((5, 7, 3)):
        members[b, :n] = torch.arange(n)
    centers = torch.tensor([[4.0, 0.0], [0.0, 1.0], [0.0, 1.0 + 1e-7]])
    q = torch.tensor([[1.0, 1.0]])
    cluster = torch.arange(3)
    assert bench_ivf.live_rows_range(q, centers, cluster, members, 2, "ip") \
        == (5 + 3, 5 + 7, 1)
    assert bench_ivf.live_rows_range(q, centers, cluster, members, 2, "ip",
                                     tie=0.0) == (5 + 3, 5 + 3, 0)
    assert bench_ivf.live_rows_range(q, centers, cluster, members, 3, "ip") \
        == (15, 15, 0)


def test_live_rows_range_probes_a_clusters_buckets_in_order():
    """Cluster 1 spills into buckets 1 and 2 (8 and 2 rows): their
    centres tie exactly, and the second probe takes bucket 1."""
    members = torch.full((4, 8), -1)
    for b, n in enumerate((5, 8, 2, 3)):
        members[b, :n] = torch.arange(n)
    centers = torch.tensor([[4.0], [2.0], [1.0]])
    cluster = torch.tensor([0, 1, 1, 2])
    q = torch.tensor([[1.0]])
    assert bench_ivf.live_rows_range(q, centers, cluster, members, 2, "ip") \
        == (13, 13, 0)
    assert bench_ivf.live_rows_range(q, centers, cluster, members, 3, "ip") \
        == (15, 15, 0)


def test_check_assign_keeps_a_sound_assignment_and_corrects_a_wrong_one(
        data, engines):
    x, _ = data
    eng = engines["l2"]
    xt = torch.from_numpy(x)
    gap, own = bench_ivf.check_assign(xt, eng.centers, eng.assign, "l2",
                                      chunk=1000)
    assert gap < 1e-6
    assert torch.equal(own, torch.as_tensor(eng.assign).long())
    wrong = eng.assign.copy()
    wrong[:50] = (wrong[:50] + 1) % K
    gap, own = bench_ivf.check_assign(xt, eng.centers, wrong, "l2",
                                      chunk=1000)
    assert gap > 1e-3
    assert torch.equal(own, torch.as_tensor(eng.assign).long())


def test_the_references_import_neither_package():
    code = """
import json, sys
sys.path.insert(0, "tests")
import plain_ivf, benchmark.reference.ivf
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "leann_tpu",
                      "leann_tpu_torch"}
