"""The benchmark's recompute cell (`recompute100k-b256`: driver
`benchmark/drivers/recompute_search.py`, the plain reference
`benchmark/reference/recompute.py`, the planted faults of
`benchmark/recompute_faults.py` and the seven per-layer readers) cut to
a tiny copy on the CPU.

The tiny cell keeps the real configuration's keys, arithmetic and
traffic at 2,000 passages, a 64-wide two-layer encoder, 16 token
positions, R = 16 and beam 16, with 2 groups of 16 queries. A run must
come out correct with every end-to-end metric positive; the bf16
control and each planted fault not. The readers load, read nothing
without a profile, and read the spans and counters as documented."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from benchmark import control, recompute_faults, run, spans
from benchmark.drivers import recompute_search
from benchmark.kernels import encoder_flops
from benchmark.tests import tiny

torch.set_num_threads(2)

CPU = torch.device("cpu")
CELL = "recompute100k-b256"
TINY = "recompute-tiny"
LIMITS = {"bad_rows": 0, "score_gap_mean": 1e-6, "recall_shortfall": 0.2}
READERS = ["recompute_encode_ms_per_batch", "recompute_traverse_ms_per_batch",
           "encoder_mfu", "recompute_mfu", "recompute_rows_per_query",
           "idle_pct.recompute", "idle_program_pct.recompute"]


def _real():
    """The benchmark's own entries: (configuration, traffic, per-layer
    metrics) of the recompute cell."""
    bench = run.load_bench()
    _, config, traffic = run.find_cell(bench, CELL)
    return config, traffic, run.metrics_of(bench, "per_layer", CELL)


def _dump(root, path, obj):
    with open(os.path.join(root, path), "w", encoding="utf-8") as f:
        json.dump(obj, f)


def tiny_config():
    config = copy.deepcopy(_real()[0])
    config.update(name="pruned_tiny", n=2000, source_n=100_000)
    config["encoder"].update(
        vocab_size=1024, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=128,
        max_position_embeddings=128)
    config["tokens"]["max_length"] = 16
    config["build"].update(graph_degree=16, complexity=24)
    config["search"]["beam_width"] = 16
    return config


def make_root(tmp):
    """A tiny root (`benchmark/tests/tiny.py`'s, for the flat cell) with
    the recompute cell added as a new configuration, traffic, limits and
    entries: the real traffic cut to tiny batches, the real readers."""
    root = tiny.make_root(tmp, cells=("flat-tiny",))
    _, traffic, layer = _real()
    traffic = {k: v for k, v in traffic.items() if k != "_path"}
    traffic.update(batch=16, pool_calls=2, profile_after_s=0.0,
                   profile_s=0.0)
    _dump(root, "benchmark/configs/pruned_tiny.json", tiny_config())
    _dump(root, "benchmark/traffic/recompute_tiny.json", traffic)
    _dump(root, f"benchmark/limits/{TINY}.json", {"limits": LIMITS})
    bench = run.load_bench(root)
    bench["configs"].append({"name": "pruned_tiny", "source": "test",
                             "file": "benchmark/configs/pruned_tiny.json",
                             "reduced": ["n"], "why": "test"})
    bench["workloads"].append({"name": TINY, "config": "pruned_tiny",
                               "traffic": "recompute_tiny", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({
        "name": traffic["rate_metric"], "unit": "queries/s",
        "better": "higher", "bound": 0.05, "source": "host_clock",
        "workloads": []})
    rates = {m["name"]: m for m in bench["end_to_end"]}
    for name in (traffic["rate_metric"], "recall_at_10"):
        rates[name]["workloads"].append(TINY)
    bench["per_layer"] += [dict(m, workloads=[TINY]) for m in layer]
    _dump(root, "BENCHMARK.json", bench)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


def test_the_benchmark_declares_the_cell_as_documented():
    bench = run.load_bench()
    cell, config, traffic = run.find_cell(bench, CELL)
    assert cell["chips"] == 1 and cell["config"] == config["name"]
    conf = {c["name"]: c for c in bench["configs"]}[config["name"]]
    assert conf["reduced"] == config["reduced"] == ["n"]
    assert config["n"] == 100_000 and config["source_n"] == 1_000_000
    enc = config["encoder"]
    assert (enc["hidden_size"], enc["num_hidden_layers"],
            enc["num_attention_heads"], enc["intermediate_size"],
            enc["vocab_size"]) == (768, 12, 12, 3072, 30522)
    assert config["tokens"]["max_length"] == 48
    e2e = run.metrics_of(bench, "end_to_end", CELL)
    assert {m["name"] for m in e2e} == {"qps.vamana", "recall_at_10",
                                        "setup_s"}
    assert traffic["rate_metric"] == "qps.vamana"
    assert [m["name"] for m in _real()[2]] == READERS
    assert all(m["moves"] == "qps.vamana" for m in _real()[2])


def test_the_tiny_cell_is_correct(root):
    line = run.run_cell(TINY, 2**31 + 26, 0.5, False, CPU, root=root)
    assert line["correct"], line["limits"]
    assert set(line["metrics"]) == {"qps.vamana", "recall_at_10", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["attempted"] > 0 and line["failed"] == 0
    numbers = {k: v["value"] for k, v in line["limits"].items()}
    assert set(numbers) == set(LIMITS)
    assert numbers["bad_rows"] == 0 and numbers["score_gap_mean"] < 1e-6


def test_set_up_prunes_and_opens_the_index_as_index_does(root):
    """The timed searcher is `GraphRecomputeSearcher` over an index that
    `StreamingIndexBuilder(is_recompute=True)` built and set-up pruned:
    no vector file, the meta pruned, the token sidecar kept."""
    from leann_tpu_torch.index.recompute import GraphRecomputeSearcher
    from leann_tpu_torch.store.embeddings import embeddings_path
    from leann_tpu_torch.store.meta import IndexMeta, meta_path
    from leann_tpu_torch.store.tokens import tokens_exist

    bench = run.load_bench(root)
    _, config, traffic = run.find_cell(bench, TINY, root)
    out = os.path.join(root, "benchmark", "_out")
    cell = recompute_search.Cell(config, traffic, 7, CPU, print, out, TINY)
    cell.inputs()
    cell.setup()
    base = cell.searcher.base
    try:
        assert type(cell.searcher) is GraphRecomputeSearcher
        assert not os.path.exists(embeddings_path(base))
        assert tokens_exist(base)
        assert IndexMeta.load(meta_path(base)).is_pruned
        assert cell.calls == []
    finally:
        cell.release()
    assert not os.path.exists(base)         # the index goes with the run


def test_the_inputs_come_from_the_seed():
    config, traffic, _ = _real()
    cells = [recompute_search.Cell(config, traffic, s, CPU, print, "", CELL)
             for s in (2**40 + 1, 2**40 + 1, 2**40 + 2)]
    for c in cells:
        c.inputs()
    a, b, c = cells
    assert a.texts == b.texts and a.groups == b.groups
    assert a.texts != c.texts
    assert len(a.texts) == 100_000 and len(set(a.texts)) == 100_000
    assert len(a.groups) == 8 and all(len(g) == 256 for g in a.groups)
    assert len({t for g in a.groups for t in g}) == 8 * 256


def test_every_reader_loads_and_reads_nothing_without_a_profile(root):
    bench = run.load_bench(root)
    assert [m["name"] for m in run.metrics_of(bench, "per_layer", TINY)] \
        == READERS
    for name in READERS:
        reader = run.load_reader(name, root)
        assert reader.read({"profile": None}, print) is None, name


def test_the_bf16_control_is_not_correct(root):
    for seed in (3, 2**31 + 4):
        out = control.control(TINY, seed, 0.5, CPU, root=root)
        assert not out["correct"], out
        assert out["numbers"]["score_gap_mean"] > LIMITS["score_gap_mean"]


def test_the_fp8_control_is_not_correct(root):
    for seed in (3, 2**31 + 4):
        out = control.control(TINY, seed, 0.5, CPU, root=root,
                              dtype=torch.float8_e4m3fn)
        assert not out["correct"], out
        assert out["numbers"]["score_gap_mean"] > LIMITS["score_gap_mean"]


@pytest.mark.parametrize("fault", sorted(recompute_faults.FAULTS))
def test_a_planted_fault_is_not_correct(root, fault):
    with recompute_faults.FAULTS[fault]():
        line = run.run_cell(TINY, 9, 0.5, False, CPU, root=root)
    assert not line["correct"], line["limits"]
    numbers = {k: v["value"] for k, v in line["limits"].items()}
    assert numbers["recall_shortfall"] > LIMITS["recall_shortfall"]


def test_a_program_without_search_many_stops_the_cell_at_once(
        root, monkeypatch):
    """A program without `GraphRecomputeSearcher.search_many` (the port
    before it) cannot run the cell: the run raises before its inputs are
    made."""
    from leann_tpu_torch.index.recompute import GraphRecomputeSearcher

    def unmade(*args, **kw):
        raise AssertionError("not reached")

    monkeypatch.delattr(GraphRecomputeSearcher, "search_many")
    monkeypatch.setattr(recompute_search, "passage_text", unmade)
    with pytest.raises(RuntimeError, match="search_many"):
        run.run_cell(TINY, 5, 0.5, False, CPU, root=root)


def test_a_program_without_the_counters_stops_the_cell_at_once(
        root, monkeypatch):
    from leann_tpu_torch.ops.beam import RecomputeBeamEngine

    monkeypatch.delattr(RecomputeBeamEngine, "misses")
    with pytest.raises(RuntimeError, match="RecomputeBeamEngine.misses"):
        run.run_cell(TINY, 5, 0.5, False, CPU, root=root)


def test_one_row_of_bert_base_at_48_positions_is_8_24_gflop():
    flops = encoder_flops.row_flops(layers=12, hidden=768,
                                    intermediate=3072, t=48)
    assert flops == 12 * (8 * 48 * 768 ** 2 + 4 * 48 * 768 * 3072
                          + 4 * 48 ** 2 * 768)
    assert round(flops / 1e9, 2) == 8.24


def _ctx(under, intervals, counts, batches=2):
    class Prof:
        start, end, window_s = 0.0, 10.0, 10.0

        def gaps(self):
            return [(1.0, 2.0)]

    sp = spans.Spans(under_s=under, intervals=intervals,
                     names=frozenset(under))
    ctx = {"profile": Prof(), "batches": batches, "recompute_counts": counts,
           "encoder": {"layers": 12, "hidden": 768, "intermediate": 3072,
                       "t": 48}}
    return sp, ctx


def test_the_readers_read_the_spans_and_counters(monkeypatch):
    under = {"recompute.search_many": 8.0, "recompute.encode": 6.0}
    counts = {"encoded_rows": 30_000, "misses": 24_000, "hops": 240,
              "traced_queries": 512}
    sp, ctx = _ctx(under, {"recompute.search_many": [(0.5, 5.0),
                                                     (5.0, 9.5)]}, counts)
    monkeypatch.setattr(spans, "load", lambda ctx, log: sp)

    def read(name):
        return run.load_reader(name).read(ctx, print)

    assert read("recompute_encode_ms_per_batch") == pytest.approx(3000.0)
    assert read("recompute_traverse_ms_per_batch") == pytest.approx(1000.0)
    useful = 24_000 * encoder_flops.row_flops(12, 768, 3072, 48)
    assert read("encoder_mfu") == pytest.approx(
        100 * useful / (6.0 * encoder_flops.H100_BF16_FLOPS))
    assert read("recompute_mfu") == pytest.approx(
        100 * useful / (9.0 * encoder_flops.H100_BF16_FLOPS))
    assert read("recompute_mfu") <= read("encoder_mfu")
    assert read("recompute_rows_per_query") == pytest.approx(30_000 / 512)
    assert read("idle_program_pct.recompute") == pytest.approx(10.0)
    ctx["recompute_counts"] = {k: 0 for k in counts}
    for name in ("encoder_mfu", "recompute_mfu", "recompute_rows_per_query"):
        assert read(name) is None, name


def test_the_readers_read_nothing_below_the_charged_share(monkeypatch):
    under = {"recompute.search_many": 8.0, "recompute.encode": 6.0}
    counts = {"encoded_rows": 3, "misses": 2, "hops": 1, "traced_queries": 1}
    sp, ctx = _ctx(under, {"recompute.search_many": [(0.0, 9.0)]}, counts)
    sp.unmatched_s = 1.0            # 8 of 9 s charged: under 95%
    monkeypatch.setattr(spans, "load", lambda ctx, log: sp)
    for name in READERS[:4] + ["idle_program_pct.recompute"]:
        assert run.load_reader(name).read(ctx, print) is None, name
    assert np.isclose(sp.charged_share("recompute.search_many"), 8 / 9)
