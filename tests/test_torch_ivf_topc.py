"""Tests of IVF stage 1's top-C select (`leann_tpu_torch/ops/ivf_topc.py`,
kernel `csrc/ivf_topc.cu`) and of `ops/ivf.py:ivf_search`'s two paths.
This file imports neither JAX nor `leann_tpu`.

On the CPU: `ivf_topc`'s plain version (the l2 fold, the sentinel mask,
`topk_stable` over the flattened positions, -1 for -inf, the tail
filled) equals `ivf_search`'s running merge over the probes bit for bit,
scores and ids, on the same dots: tables of small integers, whose bf16
products and float32 sums are exact in any order, so B4's plain dots are
the running merge's; l2 and ip; ties planted within one probe and across
probes by repeated rows; sentinel slots, empty buckets, k above the live
rows and P * cap below C. The kernel path's composition (`_kernel_scan`:
B4, then the select, in query chunks) run with CPU tensors equals the
running merge, also with a chunk budget of one to three queries.
`ivf_search.paths` counts the path taken; the wrapper's checks; the
buffers in shared memory up to c = 8,192 on the H100.

On a card (marker `cuda`, skipped without one):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ivf_topc.py

the kernel equals its plain version exactly on B4's own dots: at the IVF
benchmark cell's shape (B = 2048, P = 8, cap 650, D = 128), at B = 1, an
odd cap, C above the live rows, ties split by the kernel's tiles of 3,072
positions, and c from 1 to 9,000 (buffers in shared memory, then in a
global scratch); `IvfEngine.search` on the card agrees with the CPU
engine within `tests/test_torch_ivf.py`'s tolerance; `ivf_search.rows`
counts the same on both paths; nprobe equal to every bucket runs within
the chunk budget; `ivf_search.paths["kernel"]` and `ivf_topc.launches`
count the card's calls; the card's search reads nothing back to the
host."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from leann_tpu_torch.ops import bucket_kernels as bk
from leann_tpu_torch.ops import ivf
from leann_tpu_torch.ops import ivf_topc as it
from leann_tpu_torch.ops.distance import pairwise_scores, topk_stable

torch.set_num_threads(1)

H100_SMEM_PER_CTA = 232_448     # a CTA's opt-in shared memory (227 KB)
SHARED_STATE = 128              # the kernel's static `Shared`, at most


def _tables(rng, kp, cap, d, live, repeat=0.3):
    """Integer-valued bucket tables: (bucket_ids [K', cap] int32, sentinel
    n at the padding; bucket_vecs [K', cap, D] bf16; bucket_sq; the
    bucket centres; n). Bucket j holds live[j] rows; a share `repeat` of
    the rows copy another row (exact ties within and across buckets)."""
    n = int(sum(live))
    rows = rng.integers(-3, 4, (n, d)).astype(np.float32)
    dup = rng.random(n) < repeat
    rows[dup] = rows[rng.integers(0, n, int(dup.sum()))]
    ids = np.full((kp, cap), n, dtype=np.int32)
    vecs = np.zeros((kp, cap, d), dtype=np.float32)
    start = 0
    for j, m in enumerate(live):
        slots = np.sort(rng.choice(cap, m, replace=False))
        ids[j, slots] = np.arange(start, start + m)
        vecs[j, slots] = rows[start:start + m]
        start += m
    cent = rng.integers(-2, 3, (kp, d)).astype(np.float32)
    return (torch.from_numpy(ids), torch.from_numpy(vecs).to(torch.bfloat16),
            torch.from_numpy((vecs * vecs).sum(axis=2)),
            torch.from_numpy(cent), n)


def _queries(rng, b, d):
    return torch.from_numpy(rng.integers(-3, 4, (b, d)).astype(np.float32))


def _select(q, cent, ids, vecs, sq, k, nprobe, metric, sentinel):
    """The kernel path's two steps on the same probes, as `ivf_search`
    composes them: B4 (its plain version here), then the select."""
    probe = topk_stable(pairwise_scores(q, cent, metric), nprobe)[1]
    probe = probe.to(torch.int32)
    dots = bk.ivf_bucket_dots(q, probe, vecs)
    return it.ivf_topc(dots, probe, sq, ids, k, metric, sentinel)


# (K', cap, D, live rows per bucket, B, k, nprobe)
CASES = {
    "cell-like": (12, 40, 16, [40, 31, 17, 40, 0, 25, 38, 9, 40, 12, 33, 1],
                  9, 40, 4),
    "sentinel slots": (6, 24, 8, [3, 0, 24, 7, 1, 11], 5, 16, 3),
    "k above live rows": (8, 16, 8, [2, 5, 0, 3, 1, 16, 4, 0], 7, 50, 3),
    "P * cap below C": (5, 8, 8, [8, 6, 8, 2, 5], 4, 40, 2),
    "one query": (9, 33, 16, [33, 20, 1, 0, 33, 7, 19, 30, 2], 1, 10, 9),
    "every bucket": (7, 12, 8, [12, 3, 9, 0, 12, 6, 11], 6, 24, 7),
}


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_select_equals_the_running_merge(case, metric):
    kp, cap, d, live, b, k, nprobe = CASES[case]
    rng = np.random.default_rng(len(case) * 7 + len(metric))
    ids, vecs, sq, cent, n = _tables(rng, kp, cap, d, live)
    q = _queries(rng, b, d)
    before = dict(ivf.ivf_search.paths)
    want = ivf.ivf_search(q, cent, ids, vecs, sq, k=k, nprobe=nprobe,
                          metric=metric, sentinel=n)
    assert ivf.ivf_search.paths["torch"] == before["torch"] + 1
    assert ivf.ivf_search.paths["kernel"] == before["kernel"]
    launches = it.ivf_topc.launches
    got = _select(q, cent, ids, vecs, sq, k, nprobe, metric, n)
    assert it.ivf_topc.launches == launches       # CPU: the plain version
    assert got[0].shape == (b, k) and got[1].dtype == torch.int64
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    # ties were planted and decided: scores repeat within rows
    live_sc = want[0][torch.isfinite(want[0])]
    if case == "cell-like":
        assert live_sc.numel() > live_sc.unique().numel()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_plain_select_equals_the_running_merge_on_float_data(metric):
    """Random float tables: B4's plain dots and the running merge's are
    the same float32 products summed by the same CPU kernel."""
    rng = np.random.default_rng(9)
    ids, vecs, sq, cent, n = _tables(rng, 10, 30, 24,
                                     [30, 12, 0, 29, 30, 5, 17, 30, 8, 22])
    g = torch.Generator().manual_seed(3)
    vecs = (vecs.float() + torch.randn(vecs.shape, generator=g)).to(
        torch.bfloat16)
    vecs[ids == n] = 0
    sq = (vecs.float() ** 2).sum(2)
    q = torch.randn((11, 24), generator=g)
    want = ivf.ivf_search(q, cent, ids, vecs, sq, k=20, nprobe=4,
                          metric=metric, sentinel=n)
    got = _select(q, cent, ids, vecs, sq, 20, 4, metric, n)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("budget", [1, 2, 3, 1 << 26])
def test_kernel_path_in_query_chunks_equals_the_running_merge(
        monkeypatch, budget):
    """`_kernel_scan` with CPU tensors (B4's and the select's plain
    versions) in chunks of `budget`-bounded queries: a chunk boundary
    changes nothing, whatever splits the batch."""
    kp, cap, d, live, b, k, nprobe = CASES["cell-like"]
    rng = np.random.default_rng(31)
    ids, vecs, sq, cent, n = _tables(rng, kp, cap, d, live, repeat=0.6)
    q = _queries(rng, b, d)
    q[4] = q[3]                         # two queries tie row for row
    per_query = nprobe * cap + it.buffers(k)[1]
    monkeypatch.setattr(bk, "_PLAIN_CHUNK", budget * per_query)
    want = ivf.ivf_search(q, cent, ids, vecs, sq, k=k, nprobe=nprobe,
                          metric="l2", sentinel=n)
    probe = topk_stable(pairwise_scores(q, cent, "l2"), nprobe)[1]
    got = ivf._kernel_scan(q, probe, ids, vecs, sq, k, "l2", n)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert torch.equal(got[1][3], got[1][4])


def test_plain_select_orders_nan_first_and_masks_minus_inf():
    """Scores as torch.sort orders them: NaN above +inf, -0.0 equal to
    +0.0 (the lower position first); a live slot whose score is -inf
    comes back as (-inf, -1), as the running merge's first fill wins."""
    dots = torch.tensor([[[0.0, float("nan"), -0.0, float("-inf"), 1.0]],
                         [[-0.0, 0.0, float("inf"), float("nan"), 2.0]]])
    probe = torch.tensor([[0, 1]], dtype=torch.int32)
    ids = torch.tensor([[10, 11, 12, 13, 99], [20, 21, 22, 23, 24]],
                       dtype=torch.int32)
    sq = torch.zeros((2, 5))
    s, i = it.ivf_topc(dots, probe, sq, ids, 12, "ip", 99)
    assert i.tolist()[0] == [11, 23, 22, 24, 10, 12, 20, 21, -1, -1, -1, -1]
    assert torch.isneginf(s[0, 8:]).all()


def _bad_calls():
    dots = torch.zeros((2, 3, 5))
    probe = torch.zeros((3, 2), dtype=torch.int32)
    ids = torch.zeros((4, 5), dtype=torch.int32)
    sq = torch.zeros((4, 5))
    return {
        "dots float64": (dots.double(), probe, sq, ids, 4, "l2", TypeError),
        "probe int64": (dots, probe.long(), sq, ids, 4, "l2", TypeError),
        "ids int64": (dots, probe, sq, ids.long(), 4, "l2", TypeError),
        "sq bfloat16": (dots, probe, sq.bfloat16(), ids, 4, "l2", TypeError),
        "probe shape": (dots, probe.T.contiguous(), sq, ids, 4, "l2",
                        ValueError),
        "cap differs": (dots, probe, sq[:, :4], ids[:, :4], 4, "l2",
                        ValueError),
        "sq shape": (dots, probe, sq[:3], ids, 4, "l2", ValueError),
        "dots 2-d": (dots[0], probe, sq, ids, 4, "l2", ValueError),
        "c 0": (dots, probe, sq, ids, 0, "l2", ValueError),
        "metric cosine": (dots, probe, sq, ids, 4, "cosine", ValueError),
        "meta device": (dots.to("meta"), probe.to("meta"), sq.to("meta"),
                        ids.to("meta"), 4, "l2", ValueError),
        "mixed devices": (dots.to("meta"), probe, sq, ids, 4, "l2",
                          ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_rejects(case):
    dots, probe, sq, ids, c, metric, err = _bad_calls()[case]
    before = it.ivf_topc.launches
    with pytest.raises(err):
        it.ivf_topc(dots, probe, sq, ids, c, metric, 7)
    assert it.ivf_topc.launches == before


@pytest.mark.parametrize("c,resident", [
    (1, True), (40, True), (1024, True), (4097, True), (8192, True),
    (8193, False), (100_000, False)])
def test_buffers_stay_in_shared_memory_while_they_fit(c, resident):
    capb, ld = it.buffers(c)
    assert capb >= max(1024, 2 * (1 << (c - 1).bit_length()))
    assert ld == capb + (c + 1) // 2 * 2
    limit = H100_SMEM_PER_CTA - SHARED_STATE
    assert it.resident(c, limit) == resident
    if resident:
        assert ld * 8 + it.HIST_BYTES <= limit


def test_deferred_counts_are_added_at_each_replay():
    """What `_cuda.count_launch`, `count_path` and `count_work` count
    inside a `deferred_counts` block (a CUDA graph's capture) is kept
    aside, and `add_counts` adds it each time (each replay)."""
    from leann_tpu_torch.ops import _cuda

    def wrapper():
        pass

    wrapper.launches, wrapper.paths, wrapper.rows = 0, {"kernel": 0}, 0
    with _cuda.deferred_counts() as counts:
        _cuda.count_launch(wrapper, rows=5)
        _cuda.count_path(wrapper, "kernel")
        _cuda.count_work(wrapper, rows=torch.tensor(2))
    assert (wrapper.launches, wrapper.paths, wrapper.rows) == (
        0, {"kernel": 0}, 0)
    for _ in range(2):
        _cuda.add_counts(counts)
    assert (wrapper.launches, wrapper.paths, int(wrapper.rows)) == (
        2, {"kernel": 2}, 14)
    _cuda.count_launch(wrapper)
    assert wrapper.launches == 3


# ---------------------------------------------------------------- card

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _card_tables(dev, kp, cap, d, fill, seed):
    """Random bf16 bucket tables on the card: each bucket holds a random
    share (`fill` on average) of cap live rows, the rest sentinel slots;
    every 5th live row copies another (exact ties within and across
    buckets)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    live = torch.rand((kp, cap), generator=g, device=dev) < fill
    n = int(live.sum())
    ids = torch.full((kp, cap), n, dtype=torch.int32, device=dev)
    ids[live] = torch.arange(n, dtype=torch.int32, device=dev)
    rows = torch.randn((n, d), generator=g, device=dev)
    src = torch.randint(0, max(1, n), (n // 5,), generator=g, device=dev)
    rows[torch.arange(0, n, 5, device=dev)[: src.shape[0]]] = rows[src]
    vecs = torch.zeros((kp, cap, d), device=dev)
    vecs[live] = rows
    vecs = vecs.to(torch.bfloat16)
    sq = (vecs.float() ** 2).sum(2)
    return ids, vecs, sq, n


def _equal_to_plain(dots, probe, sq, ids, c, metric, n):
    launches = it.ivf_topc.launches
    got = it.ivf_topc(dots, probe, sq, ids, c, metric, n)
    torch.cuda.synchronize()
    assert it.ivf_topc.launches == launches + 1
    want = it.ivf_topc_plain(dots, probe, sq, ids, c, metric, n)
    bad = (got[1] != want[1]).any(dim=1).nonzero().flatten().tolist()
    assert not bad, (f"c={c}: rows {bad[:8]} differ; first: "
                     f"{got[1][bad[0], :12].tolist()} vs "
                     f"{want[1][bad[0], :12].tolist()}")
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("kp,cap,d,fill,b,p,cs", [
    (2560, 650, 128, 0.6, 2048, 8, (40,)),           # the IVF cell's shape
    (300, 37, 24, 0.5, 1, 5, (1, 10, 40, 200)),      # B = 1, odd cap
    (64, 37, 16, 0.2, 33, 3, (40, 111, 200)),        # C above the live rows
    (40, 2000, 16, 0.9, 9, 7, (1, 40, 256, 257, 4096, 8192, 9000)),
])
def test_kernel_equals_plain_on_b4_dots(dev, kp, cap, d, fill, b, p, cs,
                                        metric):
    ids, vecs, sq, n = _card_tables(dev, kp, cap, d, fill, seed=kp + cap)
    g = torch.Generator(device=dev).manual_seed(b)
    q = torch.randn((b, d), generator=g, device=dev)
    probe = topk_stable(torch.rand((b, kp), generator=g, device=dev), p)[1]
    probe = probe.to(torch.int32)
    dots = bk.ivf_bucket_dots(q, probe, vecs)
    for c in cs:
        _equal_to_plain(dots, probe, sq, ids, c, metric, n)


@pytest.mark.cuda
def test_kernel_keeps_a_tie_split_by_its_tile(dev):
    """Equal scores on both sides of positions 3,072 and 6,144 (the
    kernel's tiles) and across probes: the lower position first."""
    p, b, cap, kp = 4, 3, 2048, 4
    dots = torch.randn((p, b, cap), device=dev)
    dots[2, :, -3:] = 7.0               # positions 6,141-6,143
    dots[3, :, :3] = 7.0                # 6,144-6,146: the next tile
    dots[0, :, 100:104] = 7.0
    dots[1, :, 1021:1027] = 7.0         # 3,069-3,074
    probe = torch.arange(p, dtype=torch.int32, device=dev).expand(b, p)
    ids = torch.arange(kp * cap, dtype=torch.int32, device=dev).reshape(
        kp, cap)
    sq = torch.zeros((kp, cap), device=dev)
    for c in (1, 5, 30, 300):
        _equal_to_plain(dots, probe.contiguous(), sq, ids, c, "ip", -1)


def _engines(dev, metric="l2"):
    rng = np.random.default_rng(5)
    centers = 4.0 * rng.standard_normal((24, 32)).astype(np.float32)
    x = centers[rng.integers(0, 24, 6000)] + rng.standard_normal(
        (6000, 32)).astype(np.float32)
    cpu = ivf.IvfEngine(x, n_clusters=24, metric=metric, device="cpu")
    card = ivf.IvfEngine(x, n_clusters=24, metric=metric, device=dev,
                         centers=cpu.centers, assign=cpu.assign)
    q = x[rng.integers(0, 6000, 300)] + 0.1 * rng.standard_normal(
        (300, 32)).astype(np.float32)
    return x, q, cpu, card


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_engine_on_the_card_agrees_with_the_cpu(dev, metric):
    x, q, cpu, card = _engines(dev, metric)
    paths = dict(ivf.ivf_search.paths)
    got = card.search(q, k=10, nprobe=6)
    assert ivf.ivf_search.paths["kernel"] == paths["kernel"] + 1
    want = cpu.search(q, k=10, nprobe=6)
    # rows whose exact 10th and 11th scores differ by more than 1e-4
    xm = torch.from_numpy(x)
    qm = torch.from_numpy(q)
    if metric == "cosine":
        xm = xm / xm.norm(dim=1, keepdim=True)
        qm = qm / qm.norm(dim=1, keepdim=True)
    sc = pairwise_scores(qm.double(), xm.double(),
                         "ip" if metric == "cosine" else metric)
    top = torch.topk(sc, 11, dim=1).values
    rows = ((top[:, 9] - top[:, 10]).abs() > 1e-4).numpy()
    assert rows.mean() >= 0.5
    np.testing.assert_array_equal(got[0][rows], want[0][rows])
    np.testing.assert_allclose(got[1][rows], want[1][rows], rtol=1e-5,
                               atol=1e-4)
    for a, b in zip(got[0], want[0]):
        assert len(set(a.tolist()) & set(b.tolist())) >= 9


@pytest.mark.cuda
def test_rows_counted_alike_on_both_paths(dev):
    _, q, cpu, card = _engines(dev)
    qs = torch.from_numpy(q[:256]).reshape(2, 128, 32)
    counts = []
    for eng, qq in ((cpu, qs), (card, qs.to(dev))):
        rows0 = int(ivf.ivf_search.rows)
        queries0 = ivf.ivf_search.traced_queries
        with profile(activities=[ProfilerActivity.CPU]):
            eng.search_many_device(qq, k=10, nprobe=5)
        counts.append((int(ivf.ivf_search.rows) - rows0,
                       ivf.ivf_search.traced_queries - queries0))
    assert counts[0] == counts[1] and counts[0][0] > 0


@pytest.mark.cuda
def test_every_bucket_probed_within_the_chunk_budget(dev, monkeypatch):
    """nprobe = K' (`calibrate_nprobe`'s oracle): the kernel path cuts the
    batch into chunks of queries whose dots stay within the budget, and
    the answers equal one chunk's."""
    _, q, _, card = _engines(dev)
    kp = card.bucket_cent.shape[0]
    whole = card.search(q, k=10, nprobe=kp)
    per_query = kp * card.cap + it.buffers(40)[1]
    monkeypatch.setattr(bk, "_PLAIN_CHUNK", 7 * per_query)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    launches = it.ivf_topc.launches
    got = card.search(q, k=10, nprobe=kp)
    assert it.ivf_topc.launches == launches + -(-q.shape[0] // 7)
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert peak < 7 * per_query * 8 + (1 << 22)
    np.testing.assert_array_equal(got[0], whole[0])
    np.testing.assert_array_equal(got[1], whole[1])


@pytest.mark.cuda
def test_kernel_path_does_not_synchronize(dev):
    """`ivf_search` on the card (the probe, B4 and the select) runs under
    torch.cuda.set_sync_debug_mode("error"): nothing reads back to the
    host."""
    _, q, _, card = _engines(dev)
    qd = torch.from_numpy(q).to(dev)
    card.search_device(qd, k=10, nprobe=6)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card.search_device(qd, k=10, nprobe=6)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
