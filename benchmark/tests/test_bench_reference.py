"""The plain reference against the program at tiny sizes, on the CPU:
its pieces one by one, then whole runs of the traffic mixes,
whose comparison must come out correct with the numbers near rounding."""

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.data import vectors
from benchmark.reference import exact
from benchmark.tests import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_exact_topk_matches_the_programs_full_scan(metric):
    from leann_tpu_torch.ops.distance import exact_topk

    corpus = vectors.mixture(2000, 32, 8, 4.0, seed=9, device=CPU)
    q = vectors.near_rows(corpus, 64, seed=9, purpose="q")
    ids, _ = exact.topk(q, corpus, 10, metric)
    _, prog = exact_topk(q.numpy(), corpus.numpy(), 10, metric=metric,
                         device="cpu")
    assert (ids.numpy() == prog).mean() > 0.999


def test_same_seed_same_inputs():
    a = vectors.mixture(500, 16, 4, 4.0, seed=2**33 + 1, device=CPU)
    b = vectors.mixture(500, 16, 4, 4.0, seed=2**33 + 1, device=CPU)
    c = vectors.mixture(500, 16, 4, 4.0, seed=2**33 + 2, device=CPU)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_program_agrees_with_the_reference(cell, tmp_path):
    root = tiny.make_root(tmp_path)
    line = run.run_cell(cell, 2**31 + 11, 1.0, False, CPU, root=root)
    assert line["correct"], line["limits"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["limits"]["score_err"]["value"] < 1e-6
    for name, m in line["metrics"].items():
        assert m["value"] > 0, name
