"""The port's bench (`leann_tpu_torch/bench.py`, `python -m
leann_tpu_torch.bench`) against the root `bench.py`, on the CPU at a tiny
size.

- The pool (`leann_tpu_torch/evals/corpus_cache.py`) equals the
  reference's (`evals/corpus_cache.py`) bit for bit.
- flat / ivf / ivfpq: the root bench.py runs in a subprocess under
  JAX_PLATFORMS=cpu and the port's `main()` on the CPU with the same
  environment; the two JSON lines have the same keys and the same
  metric-string fields apart from the rate's name (`device_qps_per_chip`
  there, `cpu_qps` here) and the timing's std, and recall@10 is equal at
  the printed three decimals.
- vamana / pq: the reference's Pallas engines need interpret mode on the
  CPU, which bench.py does not ask for, so they are built as bench.py
  builds them with `interpret=True`, on the same pool, on one graph
  written in the artifact format and (pq) one PQ cache; the port's ids
  and recall@10 equal theirs exactly.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from leann_tpu_torch import bench as tb
from leann_tpu_torch.evals import corpus_cache as tcc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "evals"))

import corpus_cache as jcc  # noqa: E402

torch.set_num_threads(1)

TINY = {"BENCH_N": "4096", "BENCH_D": "32", "BENCH_B": "64",
        "BENCH_RECALL_Q": "64", "BENCH_M": "4", "BENCH_REPS": "1"}
ENV_KNOBS = ("BENCH_N", "BENCH_D", "BENCH_B", "BENCH_RECALL_Q",
             "BENCH_CLUSTERS", "BENCH_NPROBE", "BENCH_R", "BENCH_BUILD_L",
             "BENCH_SEARCH_L", "BENCH_BACKEND", "BENCH_E", "BENCH_REPS",
             "BENCH_M", "LEANN_PQ_RESCORE", "LEANN_TORCH_DEVICE")


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in ENV_KNOBS}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [ROOT, env.get("PYTHONPATH", "")] if p)
    env.update(extra)
    return env


def _fields(metric):
    """(rate name, recall, the parenthesised fields without std)."""
    m = re.fullmatch(r"(\w+)@recall10=([0-9.]+) \((.*)\)", metric)
    assert m, metric
    fields = [f for f in m.group(3).split(", ") if not f.startswith("std=")]
    return m.group(1), m.group(2), fields


def _recall(idx, oracle):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                          for a, b in zip(idx, oracle)]))


def test_pool_matches_reference_bit_for_bit():
    np.testing.assert_array_equal(tcc.get_pool(5000, 32),
                                  jcc.get_pool(5000, 32))
    # row chunks smaller than the corpus draw the same stream
    a = tcc.make_corpus(np.random.default_rng(3), 5000, 32, 16, chunk=777)
    b = jcc.make_corpus(np.random.default_rng(3), 5000, 32, 16)
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_defaults_are_bench_py_defaults(monkeypatch):
    """The root bench.py's module constants under an empty environment,
    at its full size and at a size below its nprobe switch."""
    import importlib.util

    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)
    for n in (None, "4096"):
        if n:
            monkeypatch.setenv("BENCH_N", n)
        spec = importlib.util.spec_from_file_location(
            "root_bench", os.path.join(ROOT, "bench.py"))
        ref = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ref)
        cfg = tb.Config.from_env()
        assert (cfg.n, cfg.d, cfg.batch, cfg.recall_q, cfg.n_clusters,
                cfg.n_probe, cfg.r, cfg.build_l, cfg.search_l) == (
            ref.N, ref.D, ref.QUERY_BATCH, ref.RECALL_QUERIES,
            ref.N_CLUSTERS, ref.NPROBE, ref.GRAPH_DEGREE,
            ref.BUILD_COMPLEXITY, ref.SEARCH_BEAM)
    assert (cfg.expansions, cfg.reps, cfg.m_batches, cfg.pq_m) == (
        2, 5, None, 16)


@pytest.fixture(scope="module")
def reference_lines(tmp_path_factory):
    """The root bench.py's JSON line per backend (three subprocesses
    at once)."""
    cache = str(tmp_path_factory.mktemp("jax_cache"))
    procs = {b: subprocess.Popen(
        [sys.executable, "bench.py"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_clean_env(**TINY, BENCH_BACKEND=b, JAX_PLATFORMS="cpu",
                       JAX_COMPILATION_CACHE_DIR=cache))
        for b in ("flat", "ivf", "ivfpq")}
    lines = {}
    for b, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        lines[b] = json.loads(out.strip().splitlines()[-1])
    return lines


@pytest.mark.parametrize("backend", ["flat", "ivf", "ivfpq"])
def test_cpu_line_matches_reference(backend, reference_lines, monkeypatch,
                                    capsys, tmp_path):
    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_BACKEND", backend)
    monkeypatch.setenv("LEANN_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tcc, "ART_DIR", str(tmp_path))
    assert tb.main() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = reference_lines[backend]
    assert set(line) == set(ref) == {"metric", "value", "unit",
                                     "vs_baseline"}
    assert line["unit"] == ref["unit"] == "qps"
    assert line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 10000.0, 3)
    name, recall, fields = _fields(line["metric"])
    ref_name, ref_recall, ref_fields = _fields(ref["metric"])
    assert name == f"{backend}_cpu_qps"
    assert ref_name == f"{backend}_device_qps_per_chip"
    assert fields == ref_fields
    assert recall == ref_recall


@pytest.fixture(scope="module")
def graph_case(tmp_path_factory):
    """A pool at D=128 (the fused engine's width), its Vamana graph
    written in the artifact format, the reference's two-stage oracle."""
    from leann_tpu.ops.distance import exact_topk
    from leann_tpu_torch.ops.vamana import build_vamana

    cfg = tb.Config(n=1024, d=128, batch=16, recall_q=16, r=16,
                    build_l=32, search_l=16, reps=1, m_batches=1)
    pool = tcc.get_pool(cfg.n, cfg.d, extra=cfg.recall_q + cfg.batch)
    corpus, queries = pool[:cfg.n], pool[cfg.n: cfg.n + cfg.recall_q]
    adj, med = build_vamana(corpus, graph_degree=cfg.r,
                            complexity=cfg.build_l, alpha=1.2, metric="l2",
                            wave_size=8192, device="cpu")
    art = tmp_path_factory.mktemp("artifacts")
    path = os.path.join(str(art), os.path.basename(cfg.graph_path()))
    tb.save_graph(path, adj, med)
    z = np.load(path)
    _, oracle = exact_topk(queries, corpus, 10, metric="l2", two_stage=True)
    return dict(cfg=cfg, pool=pool, corpus=corpus, queries=queries,
                adjacency=z["adjacency"], medoid=int(z["medoid"]),
                oracle=oracle, art=str(art))


def test_default_backend_follows_the_artifact(graph_case, monkeypatch,
                                              tmp_path):
    cfg = graph_case["cfg"]
    monkeypatch.setattr(tcc, "ART_DIR", str(tmp_path))
    assert tb.default_backend(cfg) == "ivf"
    monkeypatch.setattr(tcc, "ART_DIR", graph_case["art"])
    assert tb.default_backend(cfg) == "vamana"
    assert tb.default_backend(tb.Config(n=cfg.n, d=cfg.d, r=48)) == "ivf"


def test_vamana_matches_reference_engine(graph_case, monkeypatch):
    """bench.py:454-461 with interpret=True; the port loads the graph
    from the artifact."""
    from leann_tpu.ops.fused_beam import FusedBeamEngine

    g = graph_case
    cfg = g["cfg"]
    je = FusedBeamEngine(g["corpus"], g["adjacency"], g["medoid"],
                         metric="l2", expansions=cfg.expansions,
                         interpret=True)
    ji, _ = je.search(g["queries"], k=10, beam_width=cfg.search_l)
    monkeypatch.setattr(tcc, "ART_DIR", g["art"])
    out = tb.run("vamana", cfg, pool=g["pool"], device="cpu")
    np.testing.assert_array_equal(out["ids"], ji)
    assert out["recall"] == _recall(ji, g["oracle"])
    assert out["line"]["metric"].startswith(
        f"vamana_cpu_qps@recall10={out['recall']:.3f} (N=1024, d=128, "
        "R=16, beam=16, fused-kernel, std=")
    assert out["m_batches"] == 1 and out["line"]["value"] > 0


def test_pq_matches_reference_engine(graph_case, monkeypatch, tmp_path):
    """bench.py:435-452 with interpret=True; the port reads the
    reference's codebooks and codes from the PQ cache."""
    from leann_tpu.ops.pq_beam import PqBeamEngine

    g = graph_case
    cfg = g["cfg"]
    je = PqBeamEngine(g["corpus"], g["adjacency"], g["medoid"], metric="l2",
                      m=cfg.pq_m, ksub=256, rescore="bf16", interpret=True)
    ji, _ = je.search(g["queries"], k=10, beam_width=cfg.search_l)
    monkeypatch.setattr(tcc, "ART_DIR", str(tmp_path))
    np.savez(cfg.pq_path(), books=np.asarray(je.codebooks),
             codes=np.asarray(je.codes))
    out = tb.run("pq", cfg, pool=g["pool"],
                 graph=(g["adjacency"], g["medoid"]), device="cpu")
    np.testing.assert_array_equal(out["ids"], ji)
    assert out["recall"] == _recall(ji, g["oracle"])
    assert "pq-m16-kernel" in out["line"]["metric"]


def test_no_cuda_prints_the_error_line_and_fails():
    p = subprocess.run(
        [sys.executable, "-m", "leann_tpu_torch.bench"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env=_clean_env(**TINY, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["metric"].startswith("error: CUDA unavailable")
    assert (line["value"], line["unit"], line["vs_baseline"]) == (
        0.0, "qps", 0.0)


def test_bench_imports_no_jax():
    code = (
        "import sys\n"
        "from leann_tpu_torch import bench\n"
        "bench.run('flat', bench.Config(n=512, d=16, batch=16, "
        "recall_q=16, reps=1, m_batches=1), device='cpu')\n"
        "print(sorted(m for m in sys.modules if m.startswith('jax') or "
        "m.split('.')[0] in ('leann_tpu', 'corpus_cache')))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=_clean_env())
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
