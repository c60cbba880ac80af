"""A tiny copy of the benchmark's tree for CPU tests: the same drivers,
readers and reference, configurations and traffic cut to seconds."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)

CONFIGS = {
    "sift_tiny": {
        "name": "sift_tiny", "n": 3000, "d": 128, "metric": "l2",
        "precision": "float32", "clusters": 16, "center_scale": 4.0,
        "graph": {"degree": 16, "build_complexity": 24, "alpha": 1.2,
                  "wave_size": 512},
        "search": {"expansions": 2}, "reduced": []},
}

TRAFFIC = {
    "vamana_tiny": {
        "driver": "batch_search", "engine": "vamana",
        "rate_metric": "qps.vamana", "batch": 32,
        "batches_per_call": 2, "k": 10, "beam_width": 32, "pool_calls": 2,
        "sample_queries": 48, "profile_after_s": 0.0, "profile_s": 0.0},
    "flat_tiny": {
        "driver": "batch_search", "engine": "flat",
        "rate_metric": "qps.flat", "batch": 64,
        "batches_per_call": 2, "k": 10, "pool_calls": 2,
        "sample_queries": 96, "profile_after_s": 0.0, "profile_s": 0.0},
}

CELLS = {
    "vamana-tiny": ("sift_tiny", "vamana_tiny", ["qps.vamana", "recall_at_10"],
                    {"bad_rows": 0, "score_err": 1e-5,
                     "recall_shortfall": 0.1}),
    "flat-tiny": ("sift_tiny", "flat_tiny", ["qps.flat", "recall_at_10"],
                  {"bad_rows": 0, "score_err": 1e-5, "rank_gap": 1e-5}),
}


def make_root(tmp, cells=tuple(CELLS)) -> str:
    """A checkout-like tree under `tmp` holding BENCHMARK.json and the
    files it names, for `cells`; the readers are the benchmark's own."""
    root = str(tmp)
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(root, "benchmark", sub), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"),
                    os.path.join(root, "benchmark", "metrics"),
                    dirs_exist_ok=True)
    bench = {"command": ["python3", "-m", "benchmark.run"],
             "paths": ["benchmark"], "run_seconds": 1, "configs": [],
             "workloads": [], "end_to_end": [], "per_layer": []}
    e2e = {}
    for cell in cells:
        conf, traffic, metrics, limits = CELLS[cell]
        path = f"benchmark/configs/{conf}.json"
        _dump(os.path.join(root, path), CONFIGS[conf])
        if conf not in [c["name"] for c in bench["configs"]]:
            bench["configs"].append({"name": conf, "source": "test",
                                     "file": path, "reduced": [],
                                     "why": "test"})
        _dump(os.path.join(root, "benchmark", "traffic", traffic + ".json"),
              TRAFFIC[traffic])
        _dump(os.path.join(root, "benchmark", "limits", cell + ".json"),
              {"limits": limits})
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        for m in metrics:
            e2e.setdefault(m, []).append(cell)
    units = {"qps.vamana": "queries/s", "qps.flat": "queries/s",
             "recall_at_10": "fraction"}
    bench["end_to_end"] = [
        {"name": m, "unit": units[m], "better": "higher", "bound": 0.05,
         "source": "host_clock", "workloads": ws} for m, ws in e2e.items()]
    bench["end_to_end"].append({"name": "setup_s", "unit": "s",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock"})
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root


def _dump(path, obj):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1)
