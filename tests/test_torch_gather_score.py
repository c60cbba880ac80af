"""Parity of the port's row-gather scoring (`leann_tpu_torch/ops/
gather_score.py`, kernel B5's plain version) with the JAX reference
(`leann_tpu/ops/gather_score.py`: the Pallas kernel in interpret mode and
`gather_score_xla`), on the CPU, and the roofline entry point at a tiny
size.

Tolerances:
- against the Pallas kernel in interpret mode: 1e-5 x |q| x (largest row
  norm). Both add exact int8 x bf16 products in float32, in different
  orders;
- against `gather_score_xla`: rtol / atol 2e-2, the reference test's own
  bar (XLA's CPU einsum on bf16 operands may round differently);
- against the exact float32 product: 2e-2 of the largest score (the
  query's rounding to bf16)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leann_tpu.ops import gather_score as jgs
from leann_tpu_torch.evals import gather_roofline
from leann_tpu_torch.ops import gather_score as tgs

torch.set_num_threads(1)


def _case(n, b, d, r, seed):
    rng = np.random.default_rng(seed)
    corpus = rng.integers(-128, 128, (n, d)).astype(np.int8)
    ids = rng.integers(0, n, (b, r)).astype(np.int32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    return corpus, ids, q


def _tol(corpus, q):
    return 1e-5 * np.linalg.norm(q, axis=1).max() * np.linalg.norm(
        corpus.astype(np.float32), axis=1).max()


def _port(corpus, ids, q, fn=tgs.gather_score):
    return fn(torch.from_numpy(corpus), torch.from_numpy(ids),
              torch.from_numpy(q)).numpy()


@pytest.mark.parametrize("d,r", [(96, 48), (128, 48), (64, 128), (96, 7)])
def test_plain_matches_reference_kernel_and_xla(d, r):
    corpus, ids, q = _case(5000, 16, d, r, seed=0)
    args = (jnp.asarray(corpus), jnp.asarray(ids), jnp.asarray(q))
    kernel = np.asarray(jgs.gather_score(*args, qb=4, interpret=True))
    xla = np.asarray(jgs.gather_score_xla(*args))
    got = _port(corpus, ids, q, tgs.gather_score_plain)
    assert got.shape == (16, r) and got.dtype == np.float32
    np.testing.assert_allclose(got, kernel, rtol=0, atol=_tol(corpus, q))
    np.testing.assert_allclose(got, xla, rtol=2e-2, atol=2e-2)
    exact = np.einsum("brd,bd->br", corpus[ids].astype(np.float32), q)
    assert (np.abs(got - exact) / np.abs(exact).max()).max() < 2e-2


def test_duplicate_and_boundary_ids():
    n, b, d, r = 300, 8, 96, 48
    corpus, ids, q = _case(n, b, d, r, seed=1)
    ids[:, 0] = n - 1
    ids[:, 1] = 0
    ids[3, :] = 7                                    # all-duplicate row
    want = np.asarray(jgs.gather_score(
        jnp.asarray(corpus), jnp.asarray(ids), jnp.asarray(q), qb=4,
        interpret=True))
    got = _port(corpus, ids, q)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(corpus, q))
    assert np.ptp(got[3]) == 0.0


@pytest.mark.parametrize("b,d,r", [(6, 96, 200), (5, 50, 7), (1, 130, 3)])
def test_shapes_the_reference_kernel_refuses(b, d, r):
    """R > 128, B % qb != 0, D > 128 and D % 4 != 0 run in the port; the
    TPU kernel raises on the first three."""
    corpus, ids, q = _case(400, b, d, r, seed=2)
    if r > 128 or d > 128 or b % 4:
        with pytest.raises(ValueError):
            jgs.gather_score(jnp.asarray(corpus), jnp.asarray(ids),
                             jnp.asarray(q), qb=4, interpret=True)
    got = _port(corpus, ids, q)
    q_bf = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    want = np.einsum("brd,bd->br", corpus[ids].astype(np.float32), q_bf)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(corpus, q))
    # int64 ids and the ignored qb give the same scores
    again = tgs.gather_score(torch.from_numpy(corpus),
                             torch.from_numpy(ids).long(),
                             torch.from_numpy(q), qb=3).numpy()
    np.testing.assert_array_equal(again, got)


def test_wrapper_validates_and_counts_no_launch_on_cpu():
    c = torch.zeros((10, 96), dtype=torch.int8)
    q = torch.zeros((8, 96))
    ids = torch.zeros((8, 5), dtype=torch.int32)
    before = tgs.gather_score.launches
    assert tgs.gather_score(c, ids, q).shape == (8, 5)
    assert tgs.gather_score.launches == before      # CPU: the plain version
    with pytest.raises(ValueError):
        tgs.gather_score(c, ids, torch.zeros((8, 64)))
    with pytest.raises(ValueError):
        tgs.gather_score(c, torch.zeros((6, 5), dtype=torch.int32), q)
    with pytest.raises(ValueError):
        tgs.gather_score(c, ids[0], q)
    with pytest.raises(TypeError):
        tgs.gather_score(c.float(), ids, q)
    with pytest.raises(TypeError):
        tgs.gather_score(c, ids.float(), q)


def test_roofline_run_tiny_on_cpu(capsys):
    rows = gather_roofline.run(n=2000, b=8, r=5, m_scan=2, reps=2, hops=10,
                               d=96, device="cpu")
    assert [r["engine"] for r in rows] == ["gather-torch", "gather-cuda"]
    for row in rows:
        assert {"per_call_ms", "per_call_std_ms", "rows_per_s", "eff_gb_s",
                "traversal_qps_ceiling"} <= set(row)
        assert row["per_call_ms"] > 0 and row["max_abs_err"] <= row["tol"]
        assert row["device"] == "cpu" and row["timer"] == "host_clock"
    with pytest.raises(ValueError):
        gather_roofline.run(n=10, b=2, r=2, engines=("pallas",), device="cpu")
    assert gather_roofline.main(
        ["--n", "500", "--b", "4", "--r", "3", "--m-scan", "2", "--reps", "1",
         "--engines", "torch", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and '"engine": "gather-torch"' in out[0]


# --------------------------------------------------------- the launch plan

SMS = 132                                     # an H100 SXM
GRID_SHAPES = [(17, 48, 96), (31, 128, 128), (9, 7, 64), (1, 48, 128),
               (64, 48, 128), (2048, 48, 128), (6, 200, 96), (5, 200, 50),
               (33, 48, 100), (3, 512, 1024), (2, 512, 16), (1, 1, 16)]


def _check_plan(p, b, r, d):
    assert p["smem_bytes"] <= tgs.SMEM_PER_CTA
    if p["path"] == "rowwise":
        assert p["grid"] == b and p["smem_bytes"] == 4 * d
        return
    qpc, rps, chunks = p["qpc"], p["rps"], p["chunks"]
    assert d % 16 == 0 and 1 <= qpc <= b and 1 <= rps <= r
    assert chunks * rps >= r > (chunks - 1) * rps     # no empty chunk
    assert p["tiles"] == -(-b // qpc) * chunks
    assert p["stage_bytes"] % 16 == 0
    assert p["smem_bytes"] == 2 * p["stage_bytes"]
    assert p["stage_bytes"] >= qpc * (rps * d + 4 * d + rps * 4)
    assert qpc * rps <= tgs.TILE_ROWS
    assert 1 <= p["ctas_per_sm"] <= tgs.CTAS_PER_SM
    assert p["ctas_per_sm"] * (p["smem_bytes"] + 1024) <= tgs.SMEM_PER_SM
    assert 1 <= p["grid"] <= min(p["tiles"], SMS * p["ctas_per_sm"])


@pytest.mark.parametrize("b", [1, 7, 2048])
def test_launch_plan_fits_for_every_r_and_d(b):
    """R = 1..512 and D = 1..1024: the plan fits the card's 227 KB a
    block and an SM's 228 KB, its chunks cover R, and D % 16 == 0 takes
    the staged kernel."""
    plan = tgs.launch_plan.__wrapped__
    for d in range(1, 1025):
        for r in range(1, 513):
            p = plan(b, r, d, SMS)
            assert p["path"] == ("staged" if d % 16 == 0 else "rowwise")
            _check_plan(p, b, r, d)


def _tile_rows(p, b, r):
    """The staged kernel's tile -> (query, row) mapping, as
    `csrc/gather_score.cu` (`load_tile`, `copy_rows`, `score`) walks it."""
    seen = []
    for t in range(p["tiles"]):
        g, c = divmod(t, p["chunks"])
        for k in range(p["qpc"] * p["rps"]):
            qi, j = divmod(k, p["rps"])
            bb, jj = g * p["qpc"] + qi, c * p["rps"] + j
            if bb < b and jj < r:
                seen.append((bb, jj))
    return seen


@pytest.mark.parametrize("b,r,d", GRID_SHAPES)
def test_launch_plan_tiles_cover_each_row_once(b, r, d):
    p = tgs.launch_plan(b, r, d, SMS)
    _check_plan(p, b, r, d)
    if p["path"] == "staged":
        seen = _tile_rows(p, b, r)
        assert len(seen) == b * r == len(set(seen))
    # the grid keeps the card full: every SM slot has a tile where the
    # tiles allow
    if p["path"] == "staged" and p["tiles"] >= SMS * p["ctas_per_sm"]:
        assert p["grid"] == SMS * p["ctas_per_sm"]


def test_launch_plan_roofline_shape_and_alignment():
    p = tgs.launch_plan(2048, 48, 128, SMS)
    assert (p["path"], p["qpc"], p["rps"], p["chunks"]) == ("staged", 2, 48, 1)
    assert p["grid"] == SMS * tgs.CTAS_PER_SM and p["tiles"] == 1024
    # an unaligned corpus, or a D too large for two stages, goes per-row
    assert tgs.launch_plan(2048, 48, 128, SMS, aligned=False)["path"] == (
        "rowwise")
    assert tgs.launch_plan(4, 4, 30000, SMS)["path"] == "rowwise"
    # large R at large D is cut into chunks of one stage
    big = tgs.launch_plan(2, 512, 1024, SMS)
    assert big["chunks"] > 1 and big["qpc"] == 1


def test_count_launch_counts_the_path():
    from leann_tpu_torch.ops import _cuda

    def wrapper():
        pass

    wrapper.launches, wrapper.paths = 0, {"staged": 0, "rowwise": 0}
    _cuda.count_launch(wrapper, "staged")
    _cuda.count_launch(wrapper, "rowwise")
    _cuda.count_launch(wrapper, "staged")
    assert wrapper.launches == 3 and wrapper.paths == {"staged": 2,
                                                       "rowwise": 1}


def test_roofline_run_on_cpu_has_host_clock_and_no_graph_timer():
    rows = gather_roofline.run(n=1000, b=4, r=3, m_scan=2, reps=2, hops=10,
                               d=32, device="cpu")
    for row in rows:
        assert row["timer"] == "host_clock"
        assert not any("graph" in k for k in row)
        assert row["traversal_qps_ceiling"] > 0
