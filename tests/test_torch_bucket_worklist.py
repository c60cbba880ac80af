"""The work list of the bucket-major IVF scan kernels (B2, B4):
`leann_tpu_torch.ops.bucket_kernels.bucket_worklist`, on the CPU.

On the card the kernels build the same items from the same sort in one
launch (`csrc/bucket_scan.cuh: items_kernel`); `tests/test_torch_cuda.py`
holds the two equal there. These tests hold the list's contract: every
in-range (query, probe) pair listed exactly once, under its bucket, in
the order of the pair ids; items of one bucket each and at most `qmax`
pairs; probes outside [0, K) listed under bucket K; the list no longer
than the grid it is sized for; and the plain versions' rows scattered
through the list rebuild their outputs exactly (the kernels write each
pair's row where the list says)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from leann_tpu_torch.ops import bucket_kernels as tbk

torch.set_num_threads(1)


def check_worklist(probe, k, qmax):
    """Asserts the list's contract for probe [B, P] and returns it."""
    b, p = probe.shape
    n = b * p
    pairs, items = tbk.bucket_worklist(probe, k, qmax)
    assert pairs.dtype == torch.int64 and items.dtype == torch.int32
    assert items.shape == (-(-n // qmax) + min(k, n), 3)
    assert sorted(pairs.tolist()) == list(range(n))
    flat = probe.reshape(-1).tolist()
    key = [v if 0 <= v < k else k for v in flat]
    counts = items[:, 2].tolist()
    live = sum(c > 0 for c in counts)
    assert all(c > 0 for c in counts[:live])           # live items first
    assert items[live:].tolist() == [[k, n, 0]] * (len(counts) - live)
    seen = [0] * n
    pos = 0
    last = (-1, -1)
    for bucket, start, count in items[:live].tolist():
        assert 1 <= count <= qmax and 0 <= bucket <= k
        assert start == pos                            # items tile `pairs`
        members = pairs[start : start + count].tolist()
        assert all(key[m] == bucket for m in members)
        for m in members:
            seen[m] += 1
        # one bucket's items follow one another, its pairs in id order
        if bucket == last[0]:
            assert members[0] > last[1]
        else:
            assert bucket > last[0]
        assert members == sorted(members)
        last = (bucket, members[-1])
        pos += count
    assert pos == n and seen == [1] * n
    return pairs, items


@settings(max_examples=80, deadline=None, derandomize=True, database=None)
@given(b=st.integers(1, 40), p=st.integers(1, 8), k=st.integers(1, 50),
       qmax=st.sampled_from([8, 16, 32]),
       mode=st.sampled_from(["uniform", "one_bucket", "repeat_row",
                             "out_of_range"]),
       seed=st.integers(0, 2 ** 16))
def test_worklist_contract_on_random_probes(b, p, k, qmax, mode, seed):
    """Random probes: uniform, every pair on one bucket, rows that probe
    one bucket P times, and probes outside [0, K) (negative and >= K)."""
    rng = np.random.default_rng(seed)
    probe = rng.integers(0, k, (b, p))
    if mode == "one_bucket":
        probe[:] = rng.integers(0, k)
    elif mode == "repeat_row":
        probe[rng.integers(0, b)] = probe[0, 0]
    elif mode == "out_of_range":
        probe[rng.random((b, p)) < 0.3] = -1
        probe[rng.random((b, p)) < 0.2] = k + rng.integers(0, 3)
    check_worklist(torch.from_numpy(probe.astype(np.int32)), k, qmax)


@pytest.mark.parametrize("case", ["row_one_bucket", "hot_bucket", "b1",
                                  "p1", "out_of_range", "hot_and_empty"])
def test_worklist_named_cases(case):
    """The shapes the kernels must survive: a row probing one bucket P
    times; every query on one bucket (more than qmax pairs, cut into full
    items); B = 1; P = 1; probes outside [0, K); a hot bucket beside
    buckets nobody probes."""
    k, qmax = 12, 8
    if case == "row_one_bucket":
        probe = torch.randint(0, k, (5, 8), dtype=torch.int32,
                              generator=torch.Generator().manual_seed(1))
        probe[2] = 7
    elif case == "hot_bucket":
        probe = torch.full((64, 4), 3, dtype=torch.int32)
    elif case == "b1":
        probe = torch.tensor([[4, 4, 0, 11]], dtype=torch.int32)
    elif case == "p1":
        probe = torch.arange(20, dtype=torch.int32).remainder(k)[:, None]
    elif case == "out_of_range":
        probe = torch.tensor([[-1, 0, 12], [5, 99, -7]], dtype=torch.int32)
    else:
        probe = torch.full((33, 2), 11, dtype=torch.int32)
        probe[0, 1] = 0
    pairs, items = check_worklist(probe, k, qmax)
    live = items[items[:, 2] > 0].tolist()
    if case == "hot_bucket":      # 256 pairs of bucket 3: 32 full items
        assert live == [[3, 8 * i, 8] for i in range(32)]
    if case == "out_of_range":    # -1, 12, 99 and -7 under bucket K
        assert live[-1] == [k, 2, 4]
        assert pairs[2:].tolist() == [0, 2, 4, 5]
    if case == "hot_and_empty":
        assert [it[0] for it in live] == [0] + [11] * 9


@pytest.mark.parametrize("kind", ["dots", "ivf8"])
def test_worklist_scatter_rebuilds_plain_output(kind):
    """The plain version's row of each (query, probe) pair, written where
    the work list puts it, rebuilds the whole output exactly: [P, B, cap]
    for B4, [B, P, cap] for B2, with duplicate probes in a row and a
    bucket probed by every query."""
    g = torch.Generator().manual_seed(4)
    k, cap, d, b, p = 9, 21, 24, 13, 5
    q = torch.randn((b, d), generator=g)
    probe = torch.randint(0, k, (b, p), generator=g, dtype=torch.int32)
    probe[0] = probe[0, 0]
    probe[:, 1] = 2
    if kind == "dots":
        vecs = torch.randn((k, cap, d), generator=g).to(torch.bfloat16)
        ref = tbk.ivf_bucket_dots_plain(q, probe, vecs)      # [P, B, cap]
        row = lambda bb, j: ref[j, bb]
    else:
        pay = torch.randint(-127, 128, (k, cap, d), generator=g,
                            dtype=torch.int8)
        ids = torch.arange(k * cap, dtype=torch.int32).reshape(k, cap)
        ids[:, -2:] = -1
        ref = tbk.ivf8_bucket_scores_plain(
            q, probe, pay, torch.rand((k, cap), generator=g),
            torch.rand((k, cap), generator=g), ids,
            torch.randn((k, d), generator=g), "l2")          # [B, P, cap]
        row = lambda bb, j: ref[bb, j]
    out = torch.full_like(ref, float("nan"))
    pairs, items = tbk.bucket_worklist(probe, k, tbk._qmax(d))
    for bucket, start, count in items.tolist():
        for pr in pairs[start : start + count].tolist():
            bb, j = divmod(pr, p)
            assert int(probe[bb, j]) == bucket
            dst = out[j, bb] if kind == "dots" else out[bb, j]
            assert bool(torch.isnan(dst).all())              # written once
            dst.copy_(row(bb, j))
    assert torch.equal(out, ref)


def test_worklist_empty_batch():
    """B = 0: no pairs, no items."""
    pairs, items = tbk.bucket_worklist(
        torch.empty((0, 8), dtype=torch.int32), 5, 32)
    assert pairs.numel() == 0 and items.shape == (0, 3)


@pytest.mark.parametrize("d,want", [(20, 32), (24, 32), (96, 32),
                                    (128, 32), (768, 16), (2048, 8)])
def test_pairs_per_item(d, want):
    """The items' size from D: 32 pairs, halved while the staged queries
    pass 32 KiB of shared memory (the kernels check that they agree)."""
    assert tbk._qmax(d) == want
    stride = tbk._smem_stride(-(-d // 32) * 32 * 2, 2)
    assert want == 8 or want * stride <= 32768
    assert want == 32 or 2 * want * stride > 32768
