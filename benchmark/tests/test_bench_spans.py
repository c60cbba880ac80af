"""`benchmark/spans.py` and its readers on a hand-made Chrome trace:
kernels and copies, `cuda_runtime` and `cuda_driver` launch events
linked to them by `correlation`, nested program spans, idle gaps inside
and outside the outer span, and B1's expansion counter."""

import json

import pytest
import torch

from benchmark import run, spans
from benchmark.profiling import MARK, reduce_trace

MAIN, OTHER = (1, 1), (1, 2)


def _ann(name, ts, end, thread=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name,
            "pid": thread[0], "tid": thread[1], "ts": ts, "dur": end - ts}


def _launch(corr, ts, cat="cuda_runtime", thread=MAIN):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel",
            "pid": thread[0], "tid": thread[1], "ts": ts, "dur": 2,
            "args": {"correlation": corr}}


def _op(corr, ts, end, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": end - ts, "args": {"correlation": corr}}


def _trace(unmatched=False):
    """Times in us. The sub-window is [1000, 2000]; one call of the
    program, [1050, 1600], between the caller's copy in and copy out.
    Device idle: [1000, 1020] and [1700, 2000] outside the call,
    [1400, 1500] inside it, [1590, 1620] across its end (10 inside)."""
    ev = [
        _ann(MARK, 1000, 2000),
        _ann("fused_beam.search_many", 1050, 1600),
        _ann("fused_beam.seeds", 1060, 1120),
        _ann("fused_beam.b1", 1130, 1300),
        _ann("test.inner", 1140, 1200),
        _ann("fused_beam.dedup", 1310, 1340),
        _ann("fused_beam.rescore", 1350, 1380),
        # an outer span on another thread: not the run's thread
        _ann("fused_beam.search_many", 1600, 2000, OTHER),
        _launch(4, 1010), _op(4, 1020, 1100, "gpu_memcpy", "Memcpy HtoD"),
        _launch(1, 1070), _op(1, 1100, 1200),
        _launch(2, 1150, "cuda_driver"), _op(2, 1200, 1400, name="b1"),
        _launch(7, 1320), _op(7, 1500, 1540),
        _launch(8, 1360), _op(8, 1540, 1580),
        _launch(3, 1390), _op(3, 1580, 1590),      # the outer span's own
        _launch(5, 1610), _op(5, 1620, 1700, "gpu_memcpy", "Memcpy DtoH"),
    ]
    if unmatched:
        ev.append(_op(99, 1800, 1900))             # no launch on record
    return {"traceEvents": ev}


@pytest.fixture()
def ctx(tmp_path, monkeypatch):
    """A ctx as `drivers/batch_search.py` gives the readers, and its
    trace exported as profiling.py exports it, beside another run's."""
    def make(unmatched=False):
        trace = _trace(unmatched)
        (tmp_path / "cell.trace.json").write_text(json.dumps(trace))
        other = _trace()
        other["traceEvents"][0]["ts"] = 500
        (tmp_path / "other.trace.json").write_text(json.dumps(other))
        monkeypatch.setattr(spans, "OUT", str(tmp_path))
        spans._CACHE.clear()
        return {"profile": reduce_trace(trace), "batches": 2}
    return make


def _read(name, ctx):
    return run.load_reader(name).read(ctx, print)


def test_device_time_charged_to_the_innermost_span(ctx):
    c = ctx()
    sp = spans.load(c, print)
    us = pytest.approx
    assert sp.self_s == {"fused_beam.seeds": us(100e-6),
                         "test.inner": us(200e-6),
                         "fused_beam.dedup": us(40e-6),
                         "fused_beam.rescore": us(40e-6),
                         "fused_beam.search_many": us(10e-6)}
    assert sp.under_s["fused_beam.b1"] == us(200e-6)
    assert sp.under_s["fused_beam.search_many"] == us(390e-6)
    assert sp.caller_s == us(160e-6) and sp.unmatched_s == 0.0
    assert sp.charged_share("fused_beam.search_many") == 1.0
    exact = dict(rel=1e-12, abs=0)
    assert _read("vamana_seeds_ms_per_batch", c) == pytest.approx(0.05, **exact)
    assert _read("vamana_dedup_ms_per_batch", c) == pytest.approx(0.02, **exact)
    assert _read("vamana_rescore_ms_per_batch", c) == pytest.approx(0.02,
                                                                    **exact)


def test_idle_split_between_program_and_caller(ctx):
    c = ctx()
    assert run.load_reader("idle_pct.vamana").read(c, print) == \
        pytest.approx(100 * (20 + 100 + 30 + 300) / 1000, rel=1e-12)
    # inside the call, on the run's thread: [1400, 1500] and [1590, 1600]
    assert _read("idle_program_pct.vamana", c) == pytest.approx(
        100 * 110 / 1000, rel=1e-12)


def test_nothing_read_below_the_charged_share(ctx):
    c = ctx(unmatched=True)
    sp = spans.load(c, print)
    assert sp.charged_share("fused_beam.search_many") == pytest.approx(
        390 / 490, rel=1e-12)
    for name in ("vamana_seeds_ms_per_batch", "vamana_rescore_ms_per_batch",
                 "idle_program_pct.vamana"):
        assert _read(name, c) is None


def test_nothing_read_without_the_trace_or_the_span(ctx, tmp_path):
    c = ctx()
    # the flat engine's spans were not recorded in this trace
    for name in ("flat_stage1_ms_per_batch", "flat_select_ms_per_batch",
                 "flat_rescore_ms_per_batch", "idle_program_pct.flat"):
        assert _read(name, c) is None
    (tmp_path / "cell.trace.json").unlink()
    spans._CACHE.clear()
    assert _read("vamana_seeds_ms_per_batch", c) is None
    assert _read("vamana_seeds_ms_per_batch", {"batches": 2}) is None


def test_expansions_per_query_reads_the_counter():
    class Search:
        expansions = torch.tensor(1000, dtype=torch.int64)
        traced_queries = 16

    assert _read("b1_expansions_per_query", {"b1_search": Search}) == 62.5
    # a program without the counter, or one that traced nothing
    assert _read("b1_expansions_per_query", {"b1_search": object()}) is None
    Search.traced_queries = 0
    assert _read("b1_expansions_per_query", {"b1_search": Search}) is None
