"""The harness takes a new configuration, traffic mix and per-layer
metric from files of their own and `BENCHMARK.json` entries, with no
edit to a file it already has."""

import hashlib
import json
import os

import torch

from benchmark import run
from benchmark.tests import tiny

CPU = torch.device("cpu")


def _digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[p] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_config_traffic_and_metric_by_name(tmp_path, monkeypatch):
    root = tiny.make_root(tmp_path, cells=("flat-tiny",))
    before = _digests(tiny.BENCH)
    # a new configuration, a new traffic mix, a new limits file and a new
    # reader, each a file of its own, and entries in BENCHMARK.json
    cfg = dict(tiny.CONFIGS["sift_tiny"], name="sift_tiny_ip", metric="ip",
               n=1500)
    with open(os.path.join(root, "benchmark/configs/sift_tiny_ip.json"),
              "w") as f:
        json.dump(cfg, f)
    traffic = dict(tiny.TRAFFIC["flat_tiny"], batch=32, pool_calls=3)
    with open(os.path.join(root, "benchmark/traffic/flat_b32.json"),
              "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(root, "benchmark/limits/ip-b32.json"), "w") as f:
        json.dump({"limits": {"bad_rows": 0, "score_err": 1e-5}}, f)
    with open(os.path.join(root, "benchmark/metrics/calls_seen.py"),
              "w") as f:
        f.write("def read(ctx, log):\n    return 7.0\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "sift_tiny_ip", "source": "test",
                             "file": "benchmark/configs/sift_tiny_ip.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "ip-b32", "config": "sift_tiny_ip",
                               "traffic": "flat_b32", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("ip-b32")
    bench["per_layer"].append({"name": "calls_seen", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "qps.flat",
                               "workloads": ["ip-b32"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    line = run.run_cell("ip-b32", 5, 1.0, False, CPU, root=root)
    assert line["correct"]
    assert set(line["metrics"]) == {"qps.flat", "recall_at_10", "setup_s"}
    # the traced run reads the new metric (no profiler on the CPU: the
    # window's sub-window is opened only on a card)
    bench_tr = run.load_bench(root)
    ms = run.metrics_of(bench_tr, "per_layer", "ip-b32")
    assert [m["name"] for m in ms] == ["calls_seen"]
    assert run.load_reader("calls_seen", root).read({}, print) == 7.0
    assert _digests(tiny.BENCH) == before


def test_every_entry_has_its_files():
    bench = run.load_bench()
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(run.ROOT, c["file"]))
    for w in bench["workloads"]:
        for sub, name in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(
                run.ROOT, "benchmark", sub, name + ".json")), (sub, name)
        _, _, traffic = run.find_cell(bench, w["name"])
        assert os.path.exists(os.path.join(
            run.ROOT, "benchmark", "drivers", traffic["driver"] + ".py"))
    for m in bench["per_layer"]:
        assert hasattr(run.load_reader(m["name"]), "read"), m["name"]
