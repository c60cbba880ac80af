"""What the benchmark loads, and how it fails: in fresh interpreters."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run

ROOT = run.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "leann_tpu"}


def _python(code, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=env)


def test_a_tiny_cell_loads_no_jax_and_no_reference_package(tmp_path):
    code = f"""
import json, sys, torch
from benchmark import run
from benchmark.tests import tiny
root = tiny.make_root({str(tmp_path)!r})
for cell in sorted(tiny.CELLS):
    line = run.run_cell(cell, 3, 0.5, False, torch.device("cpu"), root=root)
    assert line["correct"], line
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & FORBIDDEN, top & FORBIDDEN
    assert "leann_tpu_torch" in top


def test_the_reference_loads_nothing_of_the_program():
    code = """
import json, sys
import benchmark.reference.exact, benchmark.reference.judge
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip()))
    assert not top & (FORBIDDEN | {"leann_tpu_torch"})


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "mixture1m-flat-b2048", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns("_cache", "_out",
                                                  "__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "mixture1m-flat-b2048", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_tiny_cells_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.tests import tiny

    root = tiny.make_root(tmp_path)
    for cell in sorted(tiny.CELLS):
        line = run.run_cell(cell, 31, 1.0, True, torch.device("cuda", 0),
                            root=root)
        assert line["correct"], (cell, line["limits"])
        assert line["device"]["busy_s"] > 0
