"""The benchmark's IVF cell (`mixture1m-ivf-b2048`: driver
`benchmark/drivers/ivf_search.py`, the plain IVF reference, the stage-1
bound and the nine per-layer readers) cut to a tiny copy on the CPU.

The tiny cell keeps the real traffic's keys and rate metric at 3000 x 32
with 24 lists and nprobe 4; its mixture is looser than the real one
(centres at 1x, not 4x), so that a query's last probe holds some of its
top-10 and a dropped probe shows. A run must come out correct, the bf16
control and the planted faults (`benchmark/ivf_faults.py`) not; the
readers load, read nothing where the program or the profile has nothing,
and read the bound and the counter as documented."""

import json
import os

import pytest
import torch

from benchmark import control, ivf_faults, run, spans
from benchmark.data import vectors
from benchmark.kernels import ivf_scan_bound
from benchmark.kernels.b1_bound import H100_BYTES_PER_S, H100_FP32_FLOPS
from benchmark.tests import tiny

torch.set_num_threads(1)

CPU = torch.device("cpu")
CELL = "mixture1m-ivf-b2048"
TINY = "ivf-tiny"
CONFIG = {"name": "ivf_tiny", "n": 3000, "d": 32, "metric": "l2",
          "precision": "float32", "clusters": 16, "center_scale": 1.0,
          "ivf": {"lists": 24, "kmeans_iters": 8, "kmeans_seed": 0,
                  "cap": None},
          "reduced": []}
LIMITS = {"bad_rows": 0, "score_err": 1e-5, "recall_shortfall": 0.2,
          "probe_shortfall": 0.01, "assign_gap": 1e-5, "probe_rows_gap": 0}


def _real():
    """The benchmark's own entries: (traffic, per-layer metrics) of the
    IVF cell."""
    bench = run.load_bench()
    _, _, traffic = run.find_cell(bench, CELL)
    return traffic, run.metrics_of(bench, "per_layer", CELL)


def _dump(root, path, obj):
    with open(os.path.join(root, path), "w", encoding="utf-8") as f:
        json.dump(obj, f)


def make_root(tmp, metric="l2"):
    """A tiny root (`benchmark/tests/tiny.py`'s, for the flat cell) with
    the IVF cell added as a new configuration, traffic, limits and
    entries: the real traffic cut to tiny batches, the real readers."""
    root = tiny.make_root(tmp, cells=("flat-tiny",))
    traffic, layer = _real()
    traffic = {k: v for k, v in traffic.items() if k != "_path"}
    traffic.update(batch=32, pool_calls=2, nprobe=4, sample_queries=48,
                   profile_after_s=0.0, profile_s=0.0, batches_per_call=2)
    _dump(root, "benchmark/configs/ivf_tiny.json", dict(CONFIG, metric=metric))
    _dump(root, "benchmark/traffic/ivf_tiny.json", traffic)
    _dump(root, f"benchmark/limits/{TINY}.json", {"limits": LIMITS})
    bench = run.load_bench(root)
    bench["configs"].append({"name": "ivf_tiny", "source": "test",
                             "file": "benchmark/configs/ivf_tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": TINY, "config": "ivf_tiny",
                               "traffic": "ivf_tiny", "chips": 1,
                               "why": "test"})
    rates = {m["name"]: m for m in bench["end_to_end"]}
    if traffic["rate_metric"] not in rates:
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


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_the_tiny_cell_is_correct(tmp_path, metric):
    root = make_root(tmp_path, metric)
    line = run.run_cell(TINY, 2**31 + 22, 0.5, False, CPU, root=root)
    assert line["correct"], line["limits"]
    rate = _real()[0]["rate_metric"]
    assert set(line["metrics"]) == {rate, "recall_at_10", "setup_s"}
    assert line["attempted"] > 0 and line["failed"] == 0
    numbers = {k: v["value"] for k, v in line["limits"].items()}
    assert set(numbers) == set(LIMITS)
    assert numbers["score_err"] < 1e-6 and numbers["assign_gap"] < 1e-6
    assert numbers["probe_rows_gap"] == 0


def test_every_reader_loads_and_reads_nothing_without_a_profile(tmp_path):
    root = make_root(tmp_path)
    _, layer = _real()
    assert len(layer) == 9
    bench = run.load_bench(root)
    assert [m["name"] for m in run.metrics_of(bench, "per_layer", TINY)] \
        == [m["name"] for m in layer]
    for m in layer:
        reader = run.load_reader(m["name"], root)
        assert reader.read({"profile": None}, print) is None, m["name"]


def test_the_bf16_control_is_not_correct(tmp_path):
    root = make_root(tmp_path)
    for seed in (3, 2**31 + 4):
        out = control.control(TINY, seed, 0.5, CPU, root=root)
        assert not out["correct"], out
        assert out["numbers"]["probe_shortfall"] > LIMITS["probe_shortfall"]
        assert out["numbers"]["probe_rows_gap"] > 0


@pytest.mark.parametrize("fault,number", [
    ("ivf_last_probe_dropped", "probe_shortfall"),
    ("ivf_last_probe_dropped", "probe_rows_gap"),
    ("kmeans_last_assign_skipped", "assign_gap")])
def test_a_planted_fault_is_not_correct(tmp_path, fault, number):
    root = make_root(tmp_path)
    with ivf_faults.FAULTS[fault]():
        line = run.run_cell(TINY, 9, 0.5, False, CPU, root=root)
    assert not line["correct"], line["limits"]
    assert line["limits"][number]["value"] > LIMITS[number]


def test_the_bound_counts_each_probed_bucket_once():
    """3 distinct buckets of 650, 300 and 10 live rows, probed twice each:
    each read once, its padding not at all."""
    probe = torch.tensor([[0, 1], [1, 2], [2, 0]])
    live = torch.tensor([650, 300, 10, 650])
    d, c = 128, 40
    ms, by = ivf_scan_bound.bound_ms(probe, live, d, c)
    bytes_ = 960 * (2 * d + 8) + 3 * d * 4 + 3 * c * 12
    assert by == "bytes"
    assert ms == pytest.approx(bytes_ / H100_BYTES_PER_S * 1e3)
    ops = 2 * 2 * 960 * d / H100_FP32_FLOPS * 1e3
    assert ms > ops
    padded, _ = ivf_scan_bound.bound_ms(probe, torch.full((4,), 650), d, c)
    assert padded == pytest.approx(
        (3 * 650 * (2 * d + 8) + 3 * d * 4 + 3 * c * 12)
        / H100_BYTES_PER_S * 1e3)


def test_the_scan_roofline_reads_the_bound_over_scan_and_merge(
        monkeypatch):
    under = {"ivf.search_many": 10.0, "ivf.scan": 6.0, "ivf.merge": 3.0}
    sp = spans.Spans(under_s=under, names=frozenset(under))
    monkeypatch.setattr(spans, "load", lambda ctx, log: sp)
    probes = [torch.tensor([[0, 1], [1, 2]]), torch.tensor([[3, 4], [5, 6]])]
    live = torch.tensor([650, 300, 10, 650, 600, 5, 0])
    ctx = {"profile": object(), "batches": 1000, "ivf_probes": probes,
           "ivf_live": live, "ivf_cap": 650, "d": 128, "ivf_candidates": 40}
    reader = run.load_reader("ivf_scan_roofline")
    bound = (ivf_scan_bound.bound_ms(probes[0], live, 128, 40)[0]
             + ivf_scan_bound.bound_ms(probes[1], live, 128, 40)[0]) / 2
    # scan 6 ms + merge 3 ms a batch
    assert reader.read(ctx, print) == pytest.approx(100 * bound / 9.0)
    assert torch.equal(ctx["ivf_live"], live)
    ms = run.load_reader("ivf_scan_ms_per_batch").read(ctx, print)
    assert ms == pytest.approx(6.0)


def test_a_program_that_counts_no_rows_stops_the_cell_at_once(
        tmp_path, monkeypatch):
    """A program without `ivf_search.rows` (the port before the counter)
    cannot be held to `probe_rows_gap`: the run raises before its inputs
    are made."""
    from leann_tpu_torch.ops import ivf

    def uncounted(*args, **kw):
        raise AssertionError("not reached")

    root = make_root(tmp_path)
    monkeypatch.setattr(ivf, "ivf_search", uncounted)
    monkeypatch.setattr(vectors, "mixture", uncounted)
    with pytest.raises(RuntimeError, match="counts no rows"):
        run.run_cell(TINY, 5, 0.5, False, CPU, root=root)


def test_rows_per_query_reads_the_counter():
    reader = run.load_reader("ivf_rows_per_query")

    def counted():
        pass

    counted.rows, counted.traced_queries = torch.tensor(5200), 4
    assert reader.read({"ivf_search": counted}, print) == 1300.0

    def uncounted():      # a program without the counter
        pass

    assert reader.read({"ivf_search": uncounted}, print) is None
    counted.traced_queries = 0
    assert reader.read({"ivf_search": counted}, print) is None
