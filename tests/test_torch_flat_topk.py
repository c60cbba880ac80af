"""Tests of the flat engine's top-c select (`leann_tpu_torch/ops/
flat_topk.py`, kernel `csrc/flat_topk.cu`). This file imports neither JAX
nor `leann_tpu`.

On the CPU: the wrapper's PyTorch path (CPU tensors, whatever c) is the
flat engine's select as it was, `torch.topk` of the scores, the `paths`
counter says which path ran and `launches` counts no call of it; the
wrapper's checks; the launch plan (slabs cover every column once, shared
memory within the card's 227 KB a CTA and 228 KB an SM, the buffers in
shared memory while they fit and in a global scratch above).

On a card (marker `cuda`, skipped without one):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_flat_topk.py

the kernel's ids equal `topk_stable(scale * dots + bias, c)[1]` exactly,
in order (equal scores to the lower column): rows 1, 7, 16 and 256, N
128, 65,536 and 1,048,576 with pad columns' -1e30 bias, c from 1 to
8192 (buffers in shared memory, then in the global scratch), l2 and ip,
dots from a corpus with duplicated rows (exact ties); rows of one
repeated score, of +0.0 and -0.0, with NaN, ascending and descending;
`ExactEngine.search_device` on the card, at k = 10, 200 and 1000 (c 80,
1600 and 8000), equal to the same two-stage search with `topk_stable` as
its select."""

import numpy as np
import pytest
import torch

from leann_tpu_torch.ops import distance as td
from leann_tpu_torch.ops import flat_topk as ft

torch.set_num_threads(1)

H100_SMEM_PER_SM = 233_472      # the shared memory of one SM (228 KB)
H100_SMEM_PER_CTA = 232_448     # a CTA's opt-in shared memory (227 KB)
SHARED_STATE = 176              # the kernels' static `Shared` (cuobjdump)


def _scores(rng, rows, n):
    dots = torch.from_numpy(rng.standard_normal((rows, n), dtype=np.float32))
    bias = torch.from_numpy(-rng.random(n, dtype=np.float32) * 4)
    return dots, bias


# ---------------------------------------------------------------- CPU

@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("c", [1, 10, 80])
def test_cpu_takes_the_torch_path(scale, c):
    dots, bias = _scores(np.random.default_rng(c), 5, 300)
    before = dict(ft.flat_topk.paths)
    launches = ft.flat_topk.launches
    got = ft.flat_topk(dots, bias, scale, c)
    want = torch.topk(scale * dots + bias[None, :], c, dim=1).indices
    assert torch.equal(got, want)
    assert ft.flat_topk.paths["torch"] == before["torch"] + 1
    assert ft.flat_topk.paths["kernel"] == before["kernel"]
    assert ft.flat_topk.launches == launches      # no kernel launched


def test_cpu_over_the_limit_takes_the_torch_path():
    # a c whose buffers the card would keep in global memory: the CPU
    # takes the PyTorch path at every c
    c = 8192
    assert not ft.launch_plan(3, 2 * c, c, 132)["resident"]
    dots, bias = _scores(np.random.default_rng(1), 3, 2 * c)
    out = torch.full((3, c), -7, dtype=torch.int64)
    before = dict(ft.flat_topk.paths)
    got = ft.flat_topk(dots, bias, 2.0, c, out=out)
    assert got is out
    assert torch.equal(out, torch.topk(2.0 * dots + bias[None, :], c,
                                       dim=1).indices)
    assert ft.flat_topk.paths["torch"] == before["torch"] + 1
    assert ft.flat_topk.paths["kernel"] == before["kernel"]


def test_cpu_writes_into_out_rows():
    dots, bias = _scores(np.random.default_rng(2), 6, 200)
    cand = torch.full((10, 8), -7, dtype=torch.int64)
    ft.flat_topk(dots, bias, 1.0, 8, out=cand[2:8])
    assert torch.equal(cand[2:8], torch.topk(dots + bias, 8, dim=1).indices)
    assert (cand[:2] == -7).all() and (cand[8:] == -7).all()


def _bad_calls():
    dots, bias = _scores(np.random.default_rng(3), 4, 64)
    return {
        "dots float64": (dots.double(), bias, 8, None, TypeError),
        "bias bfloat16": (dots, bias.to(torch.bfloat16), 8, None, TypeError),
        "dots 1-d": (dots[0], bias, 8, None, ValueError),
        "dots 3-d": (dots[None], bias, 8, None, ValueError),
        "bias length": (dots, bias[:63], 8, None, ValueError),
        "dots transposed": (dots.T.contiguous().T, bias, 8, None,
                            ValueError),
        "bias strided": (dots[:, ::2], bias[::2], 8, None, ValueError),
        "c 0": (dots, bias, 0, None, ValueError),
        "c above N": (dots, bias, 65, None, ValueError),
        "out shape": (dots, bias, 8, torch.empty((4, 9), dtype=torch.int64),
                      ValueError),
        "out dtype": (dots, bias, 8, torch.empty((4, 8), dtype=torch.int32),
                      ValueError),
        "out strided": (dots, bias, 8,
                        torch.empty((8, 4), dtype=torch.int64).T,
                        ValueError),
        "meta device": (dots.to("meta"), bias.to("meta"), 8, None,
                        ValueError),
        "mixed devices": (dots.to("meta"), bias, 8, None, ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_rejects(case):
    dots, bias, c, out, err = _bad_calls()[case]
    before = ft.flat_topk.launches
    with pytest.raises(err):
        ft.flat_topk(dots, bias, 2.0, c, out=out)
    assert ft.flat_topk.launches == before


ROWS = [1, 3, 4, 7, 16, 255, 256, 2048]
NS = [4, 128, 2044, 2048, 2052, 65_536, 131_072, 1_000_000, 1_048_576]
CS = [1, 10, 80, 400, 800, 1024, 2048, 4096, 6378, 6379, 8192, 100_000]


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("rows", ROWS)
def test_launch_plan_covers_every_column_once(rows, sms):
    for n in NS:
        for c in (c for c in CS if c <= n):
            p = ft.launch_plan(rows, n, c, sms)
            s, w = p["slabs"], p["slab_cols"]
            assert p["grid"] == (rows, s)
            assert w % ft.TILE == 0 and 1 <= s <= 65535
            assert s * w >= n > (s - 1) * w            # no slab empty
            if s > 1:
                assert w >= 8 * c
                assert p["ldk"] % 2 == 0 and p["ldk"] >= s * c
            pow2 = 1 << (c - 1).bit_length()
            assert p["cap"] >= max(1024, 2 * pow2)
            keep = (c + 1) // 2 * 2
            if not p["resident"]:
                assert p["scratch"] >= p["cap"] + keep
            # the buffers in shared memory exactly while they fit
            ring = ft.STAGES * ft.TILE * 4 + 1024
            assert p["resident"] == (ring + 8 * (p["cap"] + keep)
                                     + SHARED_STATE <= H100_SMEM_PER_CTA)
            assert p["smem_bytes"] + SHARED_STATE <= H100_SMEM_PER_CTA
            # ctas_per_sm CTAs on one SM, each with 1 KB the card reserves
            assert 1 <= p["ctas_per_sm"] <= ft.CTAS_PER_SM
            assert p["ctas_per_sm"] * (p["smem_bytes"] + SHARED_STATE
                                       + 1024) <= H100_SMEM_PER_SM


def test_launch_plan_at_the_flat_cell():
    # a query chunk of the flat benchmark cell: 256 x 1,048,576, c = 80;
    # one or two slabs a row would leave a wave of the 396 CTA slots of
    # 132 SMs a third idle, three fill two waves
    p = ft.launch_plan(256, 1_048_576, 80, 132)
    assert p["grid"] == (256, 3) and p["slab_cols"] == 86 * ft.TILE
    assert p["ldk"] == 240
    # a one-row serving flush spreads over the card as far as 8 * c
    # columns a slab allow
    p = ft.launch_plan(1, 131_072, 400, 132)
    assert p["grid"] == (1, 32)


@pytest.mark.parametrize("c,resident,ctas", [
    (1, True, 3), (1024, True, 3), (1025, True, 2), (2048, True, 2),
    (2049, True, 1), (6378, True, 1), (6379, False, 3), (100_000, False, 3)])
def test_launch_plan_keeps_buffers_in_shared_memory_while_they_fit(
        c, resident, ctas):
    p = ft.launch_plan(256, 1_048_576, c, 132)
    assert (p["resident"], p["ctas_per_sm"]) == (resident, ctas)
    # the launch fills most of a wave of CTAs, or its slabs are as many
    # as 8 * c columns a slab allow
    assert 256 * p["slabs"] >= ft.FULL_WAVE * ctas * 132 \
        or p["slab_cols"] < 16 * c


def test_two_stage_selects_through_the_wrapper_on_cpu():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3000, 16), dtype=np.float32)
    q = rng.standard_normal((300, 16), dtype=np.float32)
    eng = td.ExactEngine(x, metric="l2", chunk_size=1024, device="cpu")
    before = dict(ft.flat_topk.paths)
    ids, scores = eng.search_device(torch.from_numpy(q), k=10)
    # two query chunks of 256, each one call of the PyTorch path
    assert ft.flat_topk.paths["torch"] == before["torch"] + 2
    assert ft.flat_topk.paths["kernel"] == before["kernel"]
    # the select as it was: torch.topk of the chunk's scores, then the
    # candidates' rescore
    vt = td.stage1_operand(eng.vectors_bf16)
    cand = torch.cat([torch.topk(
        2.0 * td.stage1_dots(torch.from_numpy(q[s:s + 256]), vt)
        + eng.bias[None, :], 80, dim=1).indices for s in (0, 256)])
    want_sc, want_ids = td._rescore_topk(torch.from_numpy(q), eng.vectors,
                                         cand, 10, "l2")
    assert torch.equal(ids, want_ids) and torch.equal(scores, want_sc)


# ---------------------------------------------------------------- card

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _corpus_dots(dev, rows, n_pad, metric, seed):
    """Stage-1 dots and bias as ExactEngine forms them, on a corpus whose
    rows repeat (every 7th row a copy of another: exact score ties) and
    whose last rows are padding (bias -1e30)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = max(1, n_pad - 37)
    x = torch.randn((n_pad, 32), generator=g, device=dev)
    src = torch.randint(0, n, (n_pad // 7,), generator=g, device=dev)
    x[torch.arange(0, n_pad, 7, device=dev)[: src.shape[0]]] = x[src]
    x[n:] = 0
    x = x.to(torch.bfloat16).float()
    q = x[torch.randint(0, n, (rows,), generator=g, device=dev)] + 0.1 * \
        torch.randn((rows, 32), generator=g, device=dev)
    bias = td.make_bias(n, n_pad, metric, x)
    dots = td.stage1_dots(q, td.stage1_operand(x.to(torch.bfloat16)))
    return dots.contiguous(), bias


def _equal_to_stable(dots, bias, scale, c):
    before = ft.flat_topk.paths["kernel"]
    launches = ft.flat_topk.launches
    got = ft.flat_topk(dots, bias, scale, c)
    torch.cuda.synchronize()
    assert ft.flat_topk.paths["kernel"] == before + 1
    assert ft.flat_topk.launches == launches + 1
    want = td.topk_stable(scale * dots + bias[None, :], c)[1]
    bad = (got != want).any(dim=1).nonzero().flatten().tolist()
    assert not bad, (f"c={c}: rows {bad[:8]} differ; first: "
                     f"{got[bad[0], :12].tolist()} vs "
                     f"{want[bad[0], :12].tolist()}")


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("rows,n_pad", [
    (r, n) for r in (1, 16, 256) for n in (128, 65_536, 1_048_576)]
    + [(7, 65_536)])
def test_kernel_equals_topk_stable(dev, rows, n_pad, metric):
    dots, bias = _corpus_dots(dev, rows, n_pad, metric, seed=rows + n_pad)
    scale = 2.0 if metric == "l2" else 1.0
    for c in (1, 10, 80, 800, 1024, 2048, 8192):
        if c <= n_pad:
            _equal_to_stable(dots, bias, scale, c)


def _row(dev, kind, n):
    col = torch.arange(n, device=dev, dtype=torch.float32)
    if kind == "all equal":
        return torch.full((n,), 0.5, device=dev)
    if kind == "signed zeros":
        row = torch.zeros(n, device=dev)
        row[1::2] = -0.0
        row[::97] = 1.0
        row[5::131] = -1.0
        return row
    if kind == "nan":
        row = torch.randn(n, device=dev)
        row[::211] = float("nan")
        row[3::500] = float("inf")
        return row
    if kind == "ascending":
        return col
    if kind == "descending":
        return -col
    raise ValueError(kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["all equal", "signed zeros", "nan",
                                  "ascending", "descending"])
@pytest.mark.parametrize("rows,n", [(1, 65_536), (5, 1_048_576)])
def test_kernel_on_special_rows(dev, kind, rows, n):
    dots = _row(dev, kind, n).expand(rows, n).contiguous()
    # a -0.0 bias keeps -0.0 scores -0.0 (a +0.0 one would make them +0.0)
    bias = torch.full((n,), -0.0 if kind == "signed zeros" else 0.0,
                      device=dev)
    for c in (1, 80, 1024, 8192):
        _equal_to_stable(dots, bias, 1.0, c)


@pytest.mark.cuda
def test_kernel_counts_admitted_keys_while_tracing(dev):
    n, c, rows = 1_048_576, 80, 256
    bias = torch.zeros(n, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slabs = ft.launch_plan(rows, n, c, sms)["slabs"]
    up = torch.arange(n, device=dev, dtype=torch.float32)
    per_row = {}
    for name, dots in (("random", torch.randn((rows, n), device=dev)),
                       ("ascending", up.expand(rows, n).contiguous())):
        ft.flat_topk.admitted = ft.flat_topk.traced_rows = 0
        with torch.profiler.profile():
            ft.flat_topk(dots, bias, 1.0, c)
        assert ft.flat_topk.traced_rows == rows
        per_row[name] = int(ft.flat_topk.admitted) / rows
        del dots
    # every slab admits at least its c keys; on an ascending row most keys
    # lie above all before them
    assert c * slabs <= per_row["random"] < 0.1 * n
    assert per_row["ascending"] > 0.5 * n


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_pad,c", [
    (3, 65_536, 6378), (3, 65_536, 6379), (16, 1_048_576, 20_000),
    (1, 131_072, 100_000)])
def test_kernel_above_the_shared_limit_uses_the_global_scratch(
        dev, rows, n_pad, c):
    # the largest c whose buffers stay in shared memory, and above it
    dots, bias = _corpus_dots(dev, rows, n_pad, "l2", seed=5)
    card = ft._card(dev.index or 0)
    assert card[1:] == (ft.H100_SMEM_BLOCK, H100_SMEM_PER_SM)
    assert ft.launch_plan(rows, n_pad, c, *card)["resident"] == (c <= 6378)
    _equal_to_stable(dots, bias, 2.0, c)


@pytest.mark.cuda
def test_kernel_rejects_unaligned_columns(dev):
    dots = torch.randn((2, 130), device=dev)
    with pytest.raises(ValueError):
        ft.flat_topk(dots, torch.zeros(130, device=dev), 1.0, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 200, 1000])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_engine_on_cuda_equals_stable_two_stage(dev, metric, k):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((70_000, 64), dtype=np.float32)
    x[::5] = x[rng.integers(0, 70_000, 14_000)]      # duplicate rows
    q = torch.from_numpy(x[rng.integers(0, 70_000, 300)]
                         + rng.standard_normal((300, 64), dtype=np.float32)
                         ).to(dev)
    eng = td.ExactEngine(x, metric=metric, device=dev)
    before = ft.flat_topk.paths["kernel"]
    ids, scores = eng.search_device(q, k=k)
    assert ft.flat_topk.paths["kernel"] == before + 2
    scale = 2.0 if metric == "l2" else 1.0
    vt = td.stage1_operand(eng.vectors_bf16)
    cand = torch.cat([td.topk_stable(
        scale * td.stage1_dots(q[s:s + 256], vt) + eng.bias[None, :],
        8 * k)[1] for s in (0, 256)])
    want_sc, want_ids = td._rescore_topk(q, eng.vectors, cand, k, metric)
    assert torch.equal(ids, want_ids) and torch.equal(scores, want_sc)
