"""The comparison that decides `correct` must be able to fail: the
control (the reference one precision lower in the program's place) and
runs whose timed path is broken underneath, at tiny sizes on the CPU.
The cells' faults: an answer altered where it is produced (an id, a
score, the order), and half of a batch left out: its rows copied from
the first (flat), or its beams left at their entry seeds by kernel B1
(vamana, `benchmark/faults.py`), which the rescore still scores and
orders exactly."""

import pytest
import torch

from benchmark import control, run
from benchmark.tests import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_is_not_correct(cell, tmp_path):
    root = tiny.make_root(tmp_path)
    for seed in (3, 2**31 + 4, 5):
        out = control.control(cell, seed, 1.0, CPU, root=root)
        assert not out["correct"], out


def _shift_ids(ids, n):
    ids = ids.clone()
    ids[..., 3] = (ids[..., 3] + 1) % n
    return ids


BATCH_FAULTS = {
    "id": lambda ids, sc, n: (_shift_ids(ids, n), sc),
    "score": lambda ids, sc, n: (ids, sc * 1.001),
    "order": lambda ids, sc, n: (ids.flip(-1), sc.flip(-1)),
}


@pytest.mark.parametrize("fault", sorted(BATCH_FAULTS))
@pytest.mark.parametrize("cell,cls", [
    ("flat-tiny", "leann_tpu_torch.ops.distance.ExactEngine"),
    ("vamana-tiny", "leann_tpu_torch.ops.fused_beam.FusedBeamEngine")])
def test_batch_fault_is_not_correct(cell, cls, fault, tmp_path, monkeypatch):
    import importlib

    mod, name = cls.rsplit(".", 1)
    klass = getattr(importlib.import_module(mod), name)
    orig = klass.search_many_device

    def broken(self, qs, k=10, **kw):
        ids, sc = orig(self, qs, k, **kw)
        return BATCH_FAULTS[fault](ids, sc, self.n)

    monkeypatch.setattr(klass, "search_many_device", broken)
    root = tiny.make_root(tmp_path, cells=(cell,))
    line = run.run_cell(cell, 21, 1.0, False, CPU, root=root)
    assert not line["correct"], line["limits"]


def test_batch_half_the_rows_left_out_is_not_correct(tmp_path, monkeypatch):
    from leann_tpu_torch.ops.distance import ExactEngine

    orig = ExactEngine.search_many_device

    def broken(self, qs, k=10, **kw):
        ids, sc = orig(self, qs, k, **kw)
        half = qs.shape[1] // 2
        ids[:, half:] = ids[:, :1]
        sc[:, half:] = sc[:, :1]
        return ids, sc

    monkeypatch.setattr(ExactEngine, "search_many_device", broken)
    root = tiny.make_root(tmp_path, cells=("flat-tiny",))
    line = run.run_cell("flat-tiny", 22, 1.0, False, CPU, root=root)
    assert not line["correct"], line["limits"]


def test_b1_half_the_batch_at_its_seeds_is_not_correct(tmp_path,
                                                       monkeypatch):
    from benchmark.faults import b1_half_at_seeds

    # the program's entry-seed pool is the whole of a tiny corpus, where
    # seeds alone are the exact answer; at 1M it holds 4096 rows (0.4%)
    monkeypatch.setenv("LEANN_SEED_POOL", "64")
    root = tiny.make_root(tmp_path, cells=("vamana-tiny",))
    with b1_half_at_seeds():
        line = run.run_cell("vamana-tiny", 24, 1.0, False, CPU, root=root)
    lim = line["limits"]
    assert not line["correct"], lim
    # only what B1 found is wrong: the rows are valid and scored exactly
    assert lim["bad_rows"]["value"] == 0 and lim["score_err"]["value"] < 1e-6
    assert lim["recall_shortfall"]["value"] > lim["recall_shortfall"]["limit"]
    sound = run.run_cell("vamana-tiny", 24, 1.0, False, CPU, root=root)
    assert sound["correct"], sound["limits"]
