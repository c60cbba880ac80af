"""Faults planted underneath the timed path, to read what the comparison
that decides `correct` gives for them (`python3 -m benchmark.control
--fault <name>` on a card, `benchmark/tests/test_bench_control.py` on
the CPU). Each is a context manager that plants its fault in the program
and takes it out again on exit.

  b1_half_at_seeds  kernel B1 leaves the second half of every batch's
                    beams at their entry seeds, as if it had traversed
                    only the first half; the engine's rescore still
                    scores and orders what it returns exactly
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def b1_half_at_seeds():
    import torch

    from leann_tpu_torch.ops import fused_beam

    orig = fused_beam.fused_beam_search

    def broken(**kw):
        outs = orig(**kw)
        ids, sc = outs[0], outs[1]
        seed_ids, seed_sc = kw["seed_ids"], kw["seed_scores"]
        half, s = ids.shape[0] // 2, seed_ids.shape[1]
        sentinel = kw["blocks_i8"].shape[0] - 1
        ids[half:] = sentinel
        sc[half:] = -torch.inf
        ids[half:, :s] = seed_ids[half:]
        sc[half:, :s] = seed_sc[half:]
        if len(outs) > 2:           # the visited log
            outs[2][half:] = sentinel
        return outs

    engine = fused_beam.FusedBeamEngine
    orig_search = engine._search

    def search(self, *a, **kw):
        # only the engine's searches: the graph build's waves run B1 too
        broken.launches = orig.launches
        fused_beam.fused_beam_search = broken
        try:
            return orig_search(self, *a, **kw)
        finally:
            fused_beam.fused_beam_search = orig
            orig.launches = broken.launches

    engine._search = search
    try:
        yield
    finally:
        engine._search = orig_search


FAULTS = {"b1_half_at_seeds": b1_half_at_seeds}
