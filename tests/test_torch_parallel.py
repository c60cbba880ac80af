"""Parity of the port's sharded engines (`leann_tpu_torch/parallel/`)
with the JAX reference (`leann_tpu/parallel/`), on the same seeded numpy
inputs. The reference runs on its 8 virtual CPU devices (tests/conftest.py)
with Pallas in interpret mode for the fused and PQ engines, as
tests/test_parallel.py runs it; the port runs on a mesh of `cpu` devices,
where kernels B1 and B3 run their plain versions.

Each test of tests/test_parallel.py has a counterpart of the same name,
here or in tests/test_torch_parallel_searcher.py. Tolerances: ids equal exactly wherever both packages search the
same structure (flat; graphs fed the reference's own adjacency and
medoids; IVF on the reference's centers and assignment; ivf8, whose
k-means gives the reference's assignment at these sizes); scores within
1e-5, absolute or relative (float32 summation order); where each
package builds its own graph, recall@10 within 0.02 of the reference's
(the port's per-shard builds also give the reference's adjacency). The
searcher, the shard files, `init_distributed` and `dryrun_multichip` are
held in tests/test_torch_parallel_searcher.py."""

import jax
import numpy as np
import pytest
import torch

from leann_tpu import parallel as jp
from leann_tpu.ops.distance import exact_topk
from leann_tpu_torch import parallel as tp

# the suite runs in several worker processes that share the CPUs: one
# intra-op thread each keeps PyTorch's many small ops from oversubscribing
torch.set_num_threads(1)

CPU = torch.device("cpu")


def corpus(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def mesh(axes, n=8):
    """The port's mesh of `n` cpu devices and the reference's over its
    first `n` virtual devices."""
    return (tp.make_mesh(axes, devices=[CPU] * n),
            jp.make_mesh(axes, devices=jax.devices()[:n]))


def recall(idx, oracle, k=10):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                    for a, b in zip(idx, oracle)])


def assert_same(got, want):
    """Ids equal exactly; scores within 1e-5 (absolute, and relative for
    the l2 scores in the tens)."""
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- the mesh


def test_virtual_devices_present():
    """The reference sees its 8 virtual devices; the port's mesh lists a
    device as often as it is given, with shape and grid to match."""
    assert len(jax.devices()) == 8
    m = tp.make_mesh(devices=[CPU] * 8)
    assert m.shape == {"dp": 1, "shard": 8} and m.grid.shape == (1, 8)
    assert dict(jp.make_mesh().shape) == m.shape
    m = tp.make_mesh((2, 4), devices=["cpu"] * 8)
    assert m.shape == {"dp": 2, "shard": 4}
    assert m.shard_devices(3) == [CPU]
    with pytest.raises(ValueError, match="device count"):
        tp.make_mesh((3, 3), devices=[CPU] * 8)
    with pytest.raises(ValueError, match="device count"):
        jp.make_mesh((3, 3))


def test_make_mesh_without_cuda_raises(monkeypatch):
    """devices=None means every CUDA device: without one it raises, as
    `device.resolve_device` does, instead of a quiet CPU mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.make_mesh()


def test_dp_rows_share_one_copy_per_device():
    """Under a (2, 2) mesh on one device, each shard is held once."""
    x = corpus(100, 8)
    index = tp.ShardedFlatIndex(x, tp.make_mesh((2, 2), devices=[CPU] * 4))
    assert sorted(index.state) == [0, 1]
    assert all(list(st) == [CPU] for st in index.state.values())


# --------------------------------------------------------------- flat


@pytest.mark.parametrize("axes", [(1, 8), (2, 4)])
def test_sharded_flat_matches_oracle(axes):
    tm, jm = mesh(axes)
    x = corpus(1000, 32)
    q = corpus(16, 32, seed=1)
    got = tp.ShardedFlatIndex(x, tm, metric="ip").search(q, k=10)
    assert_same(got, jp.ShardedFlatIndex(x, jm, metric="ip").search(q, k=10))
    true = q @ x.T
    expected = -np.sort(-true, axis=1)[:, :10]
    found = np.take_along_axis(true, got[0], axis=1)
    np.testing.assert_allclose(-np.sort(-found, axis=1), expected,
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("axes", [(1, 8), (2, 4)])
@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
def test_sharded_flat_equals_reference(axes, metric):
    """Uneven n (999 over 4 or 8 shards), an odd batch split over dp,
    and k above the rows of a shard."""
    tm, jm = mesh(axes)
    x = corpus(999, 16, seed=2)
    q = corpus(5, 16, seed=3)
    for k in (7, 200):
        assert_same(tp.ShardedFlatIndex(x, tm, metric).search(q, k=k),
                    jp.ShardedFlatIndex(x, jm, metric).search(q, k=k))


def test_sharded_flat_l2_and_uneven_n():
    tm, jm = mesh((1, 8))
    x = corpus(999, 16, seed=2)  # not divisible by 8
    q = corpus(5, 16, seed=3)
    idx, scores = tp.ShardedFlatIndex(x, tm, metric="l2").search(q, k=7)
    assert_same((idx, scores),
                jp.ShardedFlatIndex(x, jm, metric="l2").search(q, k=7))
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    expected = np.sort(d2, axis=1)[:, :7]
    got = np.sort(np.take_along_axis(d2, idx, axis=1), axis=1)
    np.testing.assert_allclose(got, expected, rtol=1e-2, atol=1e-2)
    # no out-of-range ids from padding
    assert (idx < 999).all() and (idx >= 0).all()


# --------------------------------------------------------------- graph


@pytest.fixture(scope="module")
def ref_graph():
    """The reference's 8-shard graph over 1600 x 24 (l2, R=12, L=24),
    its search at beam 32 and the oracle."""
    x = corpus(1600, 24, seed=4)
    q = corpus(16, 24, seed=5)
    _, jm = mesh((1, 8))
    index = jp.ShardedGraphIndex(x, jm, metric="l2", graph_degree=12,
                                 complexity=24, build_wave_size=128)
    _, oracle = exact_topk(q, x, 10, metric="l2")
    return dict(x=x, q=q, index=index, oracle=oracle,
                out=index.search(q, k=10, beam_width=32))


def test_sharded_graph_recall(ref_graph):
    """The port's own per-shard builds reach the reference's recall
    (within 0.02); fed the reference's adjacency and medoids, the plain
    ("xla") engine returns the reference's ids."""
    x, q, ref = ref_graph["x"], ref_graph["q"], ref_graph["index"]
    tm, _ = mesh((1, 8))
    own = tp.ShardedGraphIndex(x, tm, metric="l2", graph_degree=12,
                               complexity=24, build_wave_size=128)
    idx, _ = own.search(q, k=10, beam_width=32)
    rec = recall(idx, ref_graph["oracle"])
    assert rec >= 0.9, f"sharded graph recall {rec}"
    assert rec >= recall(ref_graph["out"][0], ref_graph["oracle"]) - 0.02
    assert (idx < 1600).all()
    fed = tp.ShardedGraphIndex(
        x, tm, metric="l2", graph_degree=12,
        adjacency_shards=ref.adjacency_shards, medoids=ref.medoids_host)
    assert fed.engine == "xla"
    assert_same(fed.search(q, k=10, beam_width=32), ref_graph["out"])


def test_sharded_graph_dp_axis():
    tm, jm = mesh((2, 4))
    x = corpus(800, 16, seed=6)
    kw = dict(metric="l2", graph_degree=8, complexity=16, build_wave_size=128)
    ref = jp.ShardedGraphIndex(x, jm, **kw)
    index = tp.ShardedGraphIndex(x, tm, **kw)
    np.testing.assert_array_equal(index.adjacency_shards,
                                  ref.adjacency_shards)
    # query batch not divisible by dp -> padded internally
    q = x[[3, 77, 401]]
    idx, _ = index.search(q, k=5, beam_width=16)
    assert idx.shape == (3, 5)
    assert_same((idx, _), ref.search(q, k=5, beam_width=16))
    qids = np.arange(0, 800, 13)
    idx2, _ = index.search(x[qids], k=1, beam_width=16)
    rate = (idx2[:, 0] == qids).mean()
    assert rate >= 0.85, f"cross-shard self-retrieval rate {rate}"


def _kernel_engine(engine, seed, n, d, rotation=False):
    """One kernel engine on 2 shards: the reference with Pallas in
    interpret mode, then the port on the reference's adjacency and
    medoids (B1 / B3 through their plain versions on the CPU)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * 0.5).astype(np.float32)
    kw = dict(metric="l2", graph_degree=12, complexity=24, engine=engine,
              qb=8)
    if rotation:
        rot, _ = np.linalg.qr(rng.standard_normal((d, d)))
        kw["rotation"] = rot.astype(np.float32)
    q = x[rng.integers(0, n, 8)] + 0.01 * rng.standard_normal(
        (8, d)).astype(np.float32)
    tm, jm = mesh((1, 2), n=2)
    ref = jp.ShardedGraphIndex(x, jm, build_wave_size=128, interpret=True,
                               **kw)
    index = tp.ShardedGraphIndex(
        x, tm, adjacency_shards=ref.adjacency_shards,
        medoids=ref.medoids_host, **kw)
    assert index.engine == ref.engine == engine
    got = index.search(q, k=5, beam_width=16)
    assert_same(got, ref.search(q, k=5, beam_width=16))
    idx, scores = got
    _, oracle = exact_topk(q, x, 5, metric="l2")
    rec = recall(idx, oracle, k=5)
    assert rec >= 0.9, f"sharded {engine} recall {rec}"
    assert (idx < n).all() and (idx >= 0).all()
    assert (np.diff(scores, axis=1) <= 1e-4).all()
    return index


def test_sharded_graph_fused_engine_interpret():
    """B1 on every shard (its plain version on the CPU) returns the
    reference's ids: the same per-shard seed pools, entries, traversal
    and exact rescore."""
    index = _kernel_engine("fused", 10, 512, 128)
    assert index.state[0][CPU]["blocks"].shape == (257, 12, 128)


def test_sharded_graph_pq_engine_interpret():
    """B3 on every shard: one global codebook (the reference's sample and
    training), per-shard records, exact local rescore."""
    index = _kernel_engine("pq", 12, 512, 128)
    luts = [index.state[s][CPU]["lut_w"] for s in (0, 1)]
    assert luts[0] is luts[1]        # replicated: one copy per device


def test_sharded_graph_pq_engine_rotation_interpret():
    """OPQ rotation: rotated-frame codes, the rotation folded into the
    replicated LUT, rescore unchanged."""
    _kernel_engine("pq", 13, 400, 64, rotation=True)


def test_sharded_graph_auto_engine_is_xla_on_cpu(monkeypatch):
    """Auto is the plain engine on the CPU mesh, as the reference's is
    off the TPU; LEANN_GRAPH_ENGINE forces the engine as it does there."""
    tm, jm = mesh((1, 2), n=2)
    x = corpus(300, 16, seed=11)
    kw = dict(metric="l2", graph_degree=8, complexity=16, build_wave_size=128)
    assert tp.ShardedGraphIndex(x, tm, **kw).engine == "xla"
    assert jp.ShardedGraphIndex(x, jm, **kw).engine == "xla"
    monkeypatch.setenv("LEANN_GRAPH_ENGINE", "pq")
    assert tp.ShardedGraphIndex(x, tm, **kw).engine == "pq"
    assert tp.ShardedGraphIndex(x, tm, engine="xla", **kw).engine == "xla"


# --------------------------------------------------------------- ivf


def _ivf_queries(x, n_q=16, seed=8):
    rng = np.random.default_rng(seed)
    return x[rng.integers(0, len(x), n_q)] + 0.05 * rng.standard_normal(
        (n_q, x.shape[1])).astype(np.float32)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_sharded_ivf_recall(metric):
    """On the reference's centers and assignment the ids equal the
    reference's; on its own k-means the port's recall is within 0.02."""
    tm, jm = mesh((1, 8))
    x = corpus(2000, 32, seed=7)
    q = _ivf_queries(x)
    ref = jp.ShardedIvfIndex(x, jm, metric=metric, n_clusters=16)
    want = ref.search(q, k=10, nprobe=12)
    fed = tp.ShardedIvfIndex(x, tm, metric=metric, n_clusters=16,
                             centers_shards=ref.centers_host,
                             assign_shards=ref.assign_host)
    assert_same(fed.search(q, k=10, nprobe=12), want)
    own = tp.ShardedIvfIndex(x, tm, metric=metric, n_clusters=16)
    idx, scores = own.search(q, k=10, nprobe=12)
    _, oracle = exact_topk(q, x, 10, metric=metric)
    assert recall(idx, oracle) >= recall(want[0], oracle) - 0.02
    if metric == "l2":
        assert recall(idx, oracle) >= 0.85
    assert (idx < 2000).all()
    # scores descend and are true f32 scores
    assert (np.diff(scores, axis=1) <= 1e-4).all()


def test_sharded_ivf_dp_mesh_uneven_n():
    tm, jm = mesh((2, 4))
    x = corpus(777, 16, seed=9)  # uneven across 4 shards
    q = x[[5, 400, 776]]
    idx, scores = tp.ShardedIvfIndex(x, tm, metric="ip",
                                     n_clusters=8).search(q, k=5, nprobe=8)
    assert idx.shape == (3, 5)
    assert (idx < 777).all() and (idx >= 0).all()
    assert_same((idx, scores), jp.ShardedIvfIndex(
        x, jm, metric="ip", n_clusters=8).search(q, k=5, nprobe=8))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_sharded_ivf8_recall(metric):
    tm, jm = mesh((1, 8))
    x = corpus(2000, 32, seed=7)
    q = _ivf_queries(x)
    idx, scores = tp.ShardedIvf8Index(x, tm, metric=metric,
                                      n_clusters=16).search(
        q, k=10, nprobe=12, rescore_factor=8)
    want = jp.ShardedIvf8Index(x, jm, metric=metric, n_clusters=16).search(
        q, k=10, nprobe=12, rescore_factor=8)
    assert_same((idx, scores), want)
    _, oracle = exact_topk(q, x, 10, metric=metric)
    if metric == "l2":
        # residual-int8 payload: near-f32 recall at this scale
        assert recall(idx, oracle) >= 0.85
    assert (idx < 2000).all()
    assert (np.diff(scores, axis=1) <= 1e-4).all()


def test_sharded_ivf8_dp_mesh_uneven_n():
    tm, jm = mesh((2, 4))
    x = corpus(777, 16, seed=9)
    q = x[[5, 400, 776]]
    idx, scores = tp.ShardedIvf8Index(x, tm, metric="ip",
                                      n_clusters=8).search(q, k=5, nprobe=8)
    assert idx.shape == (3, 5)
    assert (idx < 777).all() and (idx >= 0).all()
    assert_same((idx, scores), jp.ShardedIvf8Index(
        x, jm, metric="ip", n_clusters=8).search(q, k=5, nprobe=8))
    # k above the rows of a shard: min(k, n) columns, -1 never valid
    idx, _ = tp.ShardedIvf8Index(x, tm, metric="ip", n_clusters=8).search(
        q, k=300, nprobe=8)
    want, _ = jp.ShardedIvf8Index(x, jm, metric="ip", n_clusters=8).search(
        q, k=300, nprobe=8)
    np.testing.assert_array_equal(idx, want)
