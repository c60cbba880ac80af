"""The port's tracing (`leann_tpu_torch/utils/trace.py`) and B1's
expansion counter, on the CPU.

Outside a profiler `device_span` records nothing and `span` records its
host seconds as before. Inside a `torch.profiler.profile` both open
ranges that the trace holds as `user_annotation` events, nested as
called: here for one `search_many_device` of `FusedBeamEngine` (its
plain traversal) and of `ExactEngine`. The plain traversal counts each
query's expansions, equal to the non-sentinel entries of a full visited
log, and `fused_beam_search` adds them to its totals only while a
profiler records."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from leann_tpu_torch.ops import _cuda
from leann_tpu_torch.ops import fused_beam as tf
from leann_tpu_torch.ops.distance import ExactEngine
from leann_tpu_torch.utils import METRICS, device_span, span, tracing

torch.set_num_threads(1)

N, D, R = 400, 128, 12


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(3)
    c = rng.standard_normal((16, D)).astype(np.float32) * 3
    x = c[rng.integers(0, 16, N)] + rng.standard_normal((N, D)).astype(
        np.float32)
    return (x / 8).astype(np.float32)


@pytest.fixture(scope="module")
def graph(corpus):
    """Exact kNN rows plus two random long edges a row."""
    xt = torch.from_numpy(corpus)
    d2 = (xt * xt).sum(1)[:, None] - 2 * xt @ xt.T + (xt * xt).sum(1)[None]
    d2.fill_diagonal_(float("inf"))
    nn = torch.topk(-d2, R - 2, dim=1).indices.numpy().astype(np.int32)
    rng = np.random.default_rng(4)
    far = rng.integers(0, N, (N, 2)).astype(np.int32)
    far = np.where(far == np.arange(N)[:, None], (far + 1) % N, far)
    return np.concatenate([nn, far], axis=1)


@pytest.fixture()
def totals():
    """B1's totals set to zero for the test, restored after it."""
    saved = (tf.fused_beam_search.expansions,
             tf.fused_beam_search.traced_queries)
    tf.fused_beam_search.expansions = 0
    tf.fused_beam_search.traced_queries = 0
    yield tf.fused_beam_search
    (tf.fused_beam_search.expansions,
     tf.fused_beam_search.traced_queries) = saved


def _annotations(prof, tmp_path):
    """(name, start, end) of every user_annotation of the trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and "dur" in e]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _kernel_args(x, adj, b=8, beam=16, track=0):
    st = tf.state_from_reference(x, adj, medoid=0, device="cpu")
    rng = np.random.default_rng(9)
    q = torch.from_numpy(x[rng.integers(0, len(x), b)] + rng.standard_normal(
        (b, D)).astype(np.float32) * 0.05)
    sc = (2.0 * q @ st["corpus"][0] - st["sq_norms"][0])[:, None]
    return dict(queries=q, blocks_i8=st["blocks"], meta_i32=st["meta"],
                seed_ids=torch.zeros((b, 1), dtype=torch.int32),
                seed_scores=sc.contiguous(),
                exclude=torch.full((b,), -1, dtype=torch.int32), r=R,
                beam_width=beam, max_iters=40, metric="l2", expansions=2,
                qb=4, ring_size=256, track_visited=track)


def test_outside_a_profiler_device_span_records_nothing():
    assert not tracing()
    before = METRICS.snapshot()
    with device_span("trace_test.device") as got:
        assert got is None
    assert device_span("a") is device_span("b")
    assert METRICS.snapshot() == before
    with span("trace_test.host"):
        pass
    with span("trace_test.host"):
        pass
    hist = METRICS.snapshot()["span.trace_test.host.seconds"]
    assert hist["type"] == "histogram" and hist["count"] == 2
    assert "span.trace_test.device.seconds" not in METRICS.snapshot()


def _session(all_threads):
    """A CPU profiling session; `all_threads` as the benchmark opens one
    (the per-thread C++ flag stays false in such a session)."""
    if not all_threads:
        return profile(activities=[ProfilerActivity.CPU])
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=[ProfilerActivity.CPU], experimental_config=cfg)


@pytest.mark.parametrize("all_threads", [False, True])
def test_span_inside_a_profiler_records_both(tmp_path, all_threads):
    before = METRICS.snapshot().get("span.trace_test.both.seconds",
                                    {"count": 0})["count"]
    with _session(all_threads) as prof:
        assert tracing()
        with span("trace_test.both"):
            with device_span("trace_test.inner"):
                torch.ones(4).sum()
    assert not tracing()
    assert METRICS.snapshot()["span.trace_test.both.seconds"]["count"] == \
        before + 1
    ann = {a[0]: a for a in _annotations(prof, tmp_path)}
    assert _inside(ann["trace_test.inner"], ann["trace_test.both"])


def test_fused_engine_spans_nest_as_called(corpus, graph, tmp_path):
    eng = tf.FusedBeamEngine(corpus, graph, 0, metric="l2", qb=4,
                             ring_size=256, device="cpu")
    rng = np.random.default_rng(5)
    qs = torch.from_numpy(corpus[rng.integers(0, N, (2, 8))])
    with _session(all_threads=True) as prof:
        ids, _ = eng.search_many_device(qs, k=5, beam_width=16)
    assert ids.shape == (2, 8, 5)
    ann = _annotations(prof, tmp_path)
    outer = [a for a in ann if a[0] == "fused_beam.search_many"]
    assert len(outer) == 1
    phases = ("fused_beam.seeds", "fused_beam.b1", "fused_beam.dedup",
              "fused_beam.rescore")
    got = sorted((a for a in ann if a[0] in phases), key=lambda a: a[1])
    # per batch, in order, each inside the outer span
    assert [a[0] for a in got] == list(phases) * 2
    assert all(_inside(a, outer[0]) for a in got)
    for a, b in zip(got, got[1:]):
        assert a[2] <= b[1]


def test_exact_engine_spans_nest_as_called(corpus, tmp_path):
    eng = ExactEngine(corpus, metric="l2", device="cpu")
    qs = torch.from_numpy(corpus[:600 // 2].reshape(2, 150, D).copy())
    with _session(all_threads=True) as prof:
        ids, _ = eng.search_many_device(qs, k=5)
    assert ids.shape == (2, 150, 5)
    ann = _annotations(prof, tmp_path)
    outer = [a for a in ann if a[0] == "exact.search_many"]
    assert len(outer) == 1
    names = ("exact.stage1", "exact.select", "exact.rescore")
    got = sorted((a for a in ann if a[0] in names), key=lambda a: a[1])
    # 150 queries at the default chunk of 256: one chunk a batch
    assert [a[0] for a in got] == list(names) * 2
    assert all(_inside(a, outer[0]) for a in got)


@pytest.mark.parametrize("expansions", [1, 2])
def test_plain_expansions_equal_a_full_visited_log(corpus, graph,
                                                   expansions):
    kw = _kernel_args(corpus, graph)
    kw.update(expansions=expansions,
              track_visited=kw["max_iters"] * expansions)
    out = tf.fused_beam_search(**kw, expansion_counts=True)
    plain = tf.fused_beam_search(**kw)
    assert len(out) == len(plain) + 1
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    counted = (out[2] != N).sum(1).to(torch.int32)
    assert out[-1].dtype == torch.int32
    assert torch.equal(out[-1], counted) and bool((counted > 0).all())
    stats = tf.fused_beam_search(**kw, merge_stats=True,
                                 expansion_counts=True)
    assert torch.equal(stats[-1], counted)
    assert bool((stats[-2] <= stats[-1]).all())    # hops <= expansions


def test_totals_grow_only_while_a_profiler_records(corpus, graph, totals):
    kw = _kernel_args(corpus, graph)
    launches = totals.launches
    expected = tf.fused_beam_search(**kw, expansion_counts=True)[-1]
    assert totals.expansions == 0 and totals.traced_queries == 0
    with profile(activities=[ProfilerActivity.CPU]):
        out = tf.fused_beam_search(**kw)
        tf.fused_beam_search(**kw)
    assert len(out) == 2
    tf.fused_beam_search(**kw)
    assert int(totals.expansions) == 2 * int(expected.sum())
    assert totals.expansions.dtype == torch.int64
    assert totals.traced_queries == 2 * kw["queries"].shape[0]
    assert totals.launches == launches      # the plain version launches none


def test_count_work_adds_ints_and_tensors():
    class Wrapper:
        launches = 0
        total = 0
        rows = 0

    _cuda.count_work(Wrapper, total=torch.tensor(3, dtype=torch.int64),
                     rows=2)
    _cuda.count_launch(Wrapper, total=torch.tensor(4, dtype=torch.int64),
                       rows=5)
    assert Wrapper.launches == 1
    assert int(Wrapper.total) == 7 and Wrapper.rows == 7


def test_count_work_is_exact_under_threads():
    """Sixteen threads adding to one wrapper's totals at a short switch
    interval lose no update."""
    import sys
    import threading

    class Wrapper:
        launches = 0
        total = 0
        rows = 0

    one = torch.tensor(1, dtype=torch.int64)

    def work():
        for _ in range(300):
            _cuda.count_launch(Wrapper, total=one, rows=2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert Wrapper.launches == 16 * 300
    assert int(Wrapper.total) == 16 * 300 and Wrapper.rows == 2 * 16 * 300


def test_ivf_engine_spans_nest_as_called(corpus, tmp_path):
    from leann_tpu_torch.ops.ivf import IvfEngine

    eng = IvfEngine(corpus, n_clusters=8, metric="l2", device="cpu")
    qs = torch.from_numpy(corpus[:64].reshape(2, 32, D).copy())
    with _session(all_threads=True) as prof:
        ids, _ = eng.search_many_device(qs, k=5, nprobe=3)
    assert ids.shape == (2, 32, 5)
    ann = _annotations(prof, tmp_path)
    outer = [a for a in ann if a[0] == "ivf.search_many"]
    assert len(outer) == 1
    names = ("ivf.probe", "ivf.scan", "ivf.merge", "ivf.rescore")
    got = sorted((a for a in ann if a[0] in names), key=lambda a: a[1])
    # per batch: the probe, a scan and a merge per probe, the rescore
    one = ["ivf.probe"] + ["ivf.scan", "ivf.merge"] * 3 + ["ivf.rescore"]
    assert [a[0] for a in got] == one * 2
    assert all(_inside(a, outer[0]) for a in got)
    for a, b in zip(got, got[1:]):
        assert a[2] <= b[1]


@pytest.fixture(scope="module")
def recompute_engine():
    """A recompute engine over 300 tiny-encoder passages (a seed pool of
    32, so hops miss the cache) and 6 of the passages' own vectors."""
    from leann_tpu_torch.models import bert
    from leann_tpu_torch.ops.beam import RecomputeBeamEngine
    from leann_tpu_torch.ops.vamana import build_vamana

    texts = [f"doc {i} topic {i % 17} shade {i % 5}" for i in range(300)]
    enc = bert.BertEncoder(config=bert.BertConfig.tiny(), device="cpu")
    vecs = enc.embed(texts)
    tok, mask = enc.tokenize_corpus(texts, max_length=16)
    adj, medoid = build_vamana(vecs, graph_degree=12, complexity=24,
                               metric="ip", wave_size=64, device="cpu")
    engine = RecomputeBeamEngine(tok, mask, adj, medoid, enc, seed_pool=32,
                                 device="cpu")
    return engine, vecs[[3, 40, 99, 150, 201, 288]]


RECOMPUTE_COUNTERS = ("encoded_rows", "misses", "hops", "traced_queries")


@pytest.fixture()
def recompute_totals():
    """The recompute engine's class totals set to zero for the test,
    restored after it."""
    from leann_tpu_torch.ops.beam import RecomputeBeamEngine

    saved = {c: getattr(RecomputeBeamEngine, c) for c in RECOMPUTE_COUNTERS}
    for c in RECOMPUTE_COUNTERS:
        setattr(RecomputeBeamEngine, c, 0)
    yield RecomputeBeamEngine
    for c, v in saved.items():
        setattr(RecomputeBeamEngine, c, v)


def test_recompute_counters_stay_zero_while_untraced(recompute_engine,
                                                     recompute_totals):
    engine, q = recompute_engine
    engine.search(q, k=5, beam_width=16)
    engine.search(q, k=5, beam_width=16, dedup=False)
    assert engine.last_stats["hops"] > 0
    assert all(getattr(recompute_totals, c) == 0 for c in RECOMPUTE_COUNTERS)


@pytest.mark.parametrize("dedup", [True, False])
def test_recompute_spans_and_counters_while_tracing(
        recompute_engine, recompute_totals, tmp_path, dedup):
    """Inside a profiler the engine's search opens `recompute.search_many`
    around `recompute.entry` and, per hop, `recompute.dedup` (with the
    cache), `recompute.encode` and `recompute.score`, in that order; the
    class totals equal the search's own `last_stats`."""
    engine, q = recompute_engine
    with _session(all_threads=True) as prof:
        ids, _ = engine.search(q, k=5, beam_width=16, dedup=dedup)
    assert ids.shape == (6, 5)
    stats = engine.last_stats
    ann = _annotations(prof, tmp_path)
    outer = [a for a in ann if a[0] == "recompute.search_many"]
    assert len(outer) == 1
    inner = sorted((a for a in ann if a[0].startswith("recompute.")
                    and a is not outer[0]), key=lambda a: a[1])
    assert all(_inside(a, outer[0]) for a in inner)
    hop = (["recompute.dedup"] if dedup else []) + ["recompute.encode",
                                                    "recompute.score"]
    assert [a[0] for a in inner] == ["recompute.entry"] + hop * stats["hops"]
    for a, b in zip(inner, inner[1:]):
        assert a[2] <= b[1]
    t = recompute_totals
    assert t.hops == stats["hops"] and t.traced_queries == 6
    assert t.encoded_rows == stats["encoded_rows"]
    if dedup:
        assert 0 < t.misses == stats["misses"] <= t.encoded_rows
    else:
        assert t.misses == t.encoded_rows == stats["slots"]
