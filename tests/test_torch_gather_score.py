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
