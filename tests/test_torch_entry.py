"""The port's `entry()` (`leann_tpu_torch/entry.py`) against the
reference's (`__graft_entry__.entry`), on the CPU: a tiny encoder embeds
512 texts, a Vamana graph links them, and the forward step encodes 16
queries and beam-searches the graph.

Tolerances: ids equal wherever neighbouring scores of the reference's
top 11 differ by more than 1e-3 (the two encoders' bf16 products move a
score by up to ~1e-4), scores within 1e-3."""

import jax
import numpy as np
import torch

import __graft_entry__ as graft
from leann_tpu_torch.entry import entry

torch.set_num_threads(1)


def test_entry_matches_reference_on_cpu():
    jfn, jargs = graft.entry()
    want_ids, want_sc = (np.asarray(a) for a in jax.jit(jfn)(*jargs))
    fn, args = entry(device="cpu")
    assert all(t.device.type == "cpu" for t in args[1:])
    assert isinstance(args[0], torch.nn.Module)
    ids, sc = fn(*args)
    assert ids.shape == sc.shape == (16, 10)
    assert ids.dtype == torch.int64 and sc.dtype == torch.float32
    ids, sc = ids.numpy(), sc.numpy()
    np.testing.assert_allclose(sc, want_sc, rtol=0, atol=1e-3)
    # positions whose score is separated from both neighbours
    gap = np.abs(np.diff(want_sc, axis=1)) > 1e-3
    clear = np.ones_like(want_ids, dtype=bool)
    clear[:, 1:] &= gap
    clear[:, :-1] &= gap
    clear[:, -1] = False        # the 11th score is not returned
    assert clear.mean() >= 0.3
    np.testing.assert_array_equal(ids[clear], want_ids[clear])
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                       for a, b in zip(ids, want_ids)])
    assert overlap >= 0.9
    # the same call again returns the same tensors
    again = fn(*args)
    assert np.array_equal(again[0].numpy(), ids)
