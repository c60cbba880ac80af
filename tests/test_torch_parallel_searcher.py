"""The port's sharded searcher (`leann_tpu_torch.backend.ShardedSearcher`),
its `.shards.npz` sidecar (`store/shardfile.py`), `init_distributed` and
`dryrun_multichip`, against the JAX reference on the same index files.

The reference's `ShardedSearcher` lays its mesh over the 8 virtual CPU
devices of tests/conftest.py; the port's takes `devices=["cpu"] * 8`.
Tolerances: a stored row's own vector finds it; a sidecar written by one
package and loaded by the other (whose builders are poisoned, so nothing
is rebuilt) gives the writer's ids exactly; two processes joined by gloo
return one process's ids and scores exactly."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from leann_tpu_torch.backend import load_searcher
from leann_tpu_torch.index import IndexBuilder, IndexSearcher
from leann_tpu_torch.store import shardfile
from leann_tpu_torch.store.meta import IndexMeta, meta_path

# the suite runs in several worker processes that share the CPUs: one
# intra-op thread each keeps PyTorch's many small ops from oversubscribing
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8


def _build_small_index(base, backend, n=400, d=32, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    builder = IndexBuilder(base, dim=d, backend=backend, device="cpu")
    for i in range(n):
        builder.add(f"p{i}", f"passage {i}", vecs[i], {"n": i})
    builder.build()
    return vecs


def _poison(monkeypatch, module, name):
    def boom(*a, **k):  # pragma: no cover
        raise AssertionError(f"{name} re-run despite persisted shards")

    monkeypatch.setattr(module, name, boom)


@pytest.mark.parametrize("backend", ["flat", "vamana", "ivf"])
def test_sharded_searcher_all_backends(tmp_path, backend):
    base = str(tmp_path / "documents.leann")
    vecs = _build_small_index(base, backend)
    meta = IndexMeta.load(meta_path(base))
    s = load_searcher(base, meta, sharded=True, device=CPU8)
    assert s.n_shards == 8 and len(s) == 400

    q = vecs[7] + np.random.default_rng(1).standard_normal(32) * 0.01
    idx, _ = s.search(q[None].astype(np.float32), k=5, complexity=64)
    assert 7 in idx[0]
    # through IndexSearcher: the device list passes on to the mesh
    res = IndexSearcher(base, sharded=True, device=CPU8).search(vecs[7:8])
    assert res[0][0].id == "p7"
    one = load_searcher(base, meta, sharded=True, device="cpu")
    assert one.n_shards == 1


def test_sharded_artifacts_persist_and_reload(tmp_path, monkeypatch):
    import leann_tpu_torch.ops.vamana as vam

    base = str(tmp_path / "documents.leann")
    vecs = _build_small_index(base, "vamana")
    meta = IndexMeta.load(meta_path(base))
    s1 = load_searcher(base, meta, sharded=True, device=CPU8)
    assert os.path.exists(shardfile.shards_path(base))
    q = vecs[3:5].astype(np.float32)
    idx1, sc1 = s1.search(q, k=5)

    # the second load must NOT rebuild
    _poison(monkeypatch, vam, "build_vamana")
    s2 = load_searcher(base, meta, sharded=True, device=CPU8)
    idx2, sc2 = s2.search(q, k=5)
    np.testing.assert_array_equal(idx1, idx2)
    np.testing.assert_array_equal(sc1, sc2)


def test_sharded_ivf_artifacts_reload(tmp_path, monkeypatch):
    import leann_tpu_torch.ops.ivf as ivfops

    base = str(tmp_path / "documents.leann")
    vecs = _build_small_index(base, "ivf")
    meta = IndexMeta.load(meta_path(base))
    s1 = load_searcher(base, meta, sharded=True, device=CPU8)
    assert os.path.exists(shardfile.shards_path(base))
    q = vecs[11:12].astype(np.float32)
    idx1, _ = s1.search(q, k=5)

    _poison(monkeypatch, ivfops, "kmeans")
    s2 = load_searcher(base, meta, sharded=True, device=CPU8)
    idx2, _ = s2.search(q, k=5)
    np.testing.assert_array_equal(idx1, idx2)


def test_shardfile_rejects_wrong_shard_count(tmp_path):
    """The port's copy writes the reference's keys and dtypes: each
    package reads the other's file, and a shard count that differs
    returns None in both."""
    from leann_tpu.store import shardfile as jsf

    base = str(tmp_path / "documents.leann")
    adj = np.arange(4 * 10 * 8, dtype=np.int32).reshape(4, 10, 8)
    med = np.arange(4, dtype=np.int32)
    shardfile.save_graph_shards(base, adj, med, n=40, metric="ip")
    assert shardfile.load_shards(base, 4) is not None
    assert shardfile.load_shards(base, 8) is None
    got = jsf.load_shards(base, 4, n=40, metric="ip")
    np.testing.assert_array_equal(got["adjacency"], adj)
    assert jsf.load_shards(base, 8) is None
    centers = [np.full((3, 2), i, np.float32) for i in range(2)]
    assign = [np.zeros(5, np.int32), np.ones(4, np.int32)]
    for writer, reader in ((shardfile, jsf), (jsf, shardfile)):
        writer.save_ivf_shards(base, centers, assign, n=9, metric="l2")
        art = reader.load_shards(base, 2, n=9, metric="l2")
        assert art["kind"] == "ivf"
        for a, b in zip(art["centers_list"] + art["assign_list"],
                        centers + assign):
            np.testing.assert_array_equal(a, b)
        assert reader.load_shards(base, 2, n=10) is None


@pytest.mark.parametrize("backend", ["vamana", "ivf"])
def test_shard_files_cross_load_both_ways(tmp_path, monkeypatch, backend):
    """A sidecar written by either package's ShardedSearcher loads in
    the other's at the same shard count (8), nothing rebuilt, and
    returns the writer's ids."""
    import leann_tpu.ops.ivf as jivf
    import leann_tpu.ops.vamana as jvam
    import leann_tpu_torch.ops.ivf as tivf
    import leann_tpu_torch.ops.vamana as tvam
    from leann_tpu.backend import load_searcher as jax_load_searcher
    from leann_tpu.store.meta import IndexMeta as JaxIndexMeta

    base = str(tmp_path / "documents.leann")
    vecs = _build_small_index(base, backend)
    meta = IndexMeta.load(meta_path(base))
    jmeta = JaxIndexMeta.load(meta_path(base))
    q = vecs[[3, 50, 399]] + 0.01
    name = "build_vamana" if backend == "vamana" else "kmeans"

    with monkeypatch.context() as m:   # the port writes, the JAX reads
        want = load_searcher(base, meta, sharded=True, device=CPU8).search(
            q, k=5)
        _poison(m, jvam if backend == "vamana" else jivf, name)
        got = jax_load_searcher(base, jmeta, sharded=True).search(q, k=5)
        np.testing.assert_array_equal(got[0], want[0])

    shardfile.invalidate_shards(base)
    with monkeypatch.context() as m:   # the JAX writes, the port reads
        want = jax_load_searcher(base, jmeta, sharded=True).search(q, k=5)
        _poison(m, tvam if backend == "vamana" else tivf, name)
        got = load_searcher(base, meta, sharded=True, device=CPU8).search(
            q, k=5)
        np.testing.assert_array_equal(got[0], want[0])


def test_wrong_shard_count_is_rebuilt_and_rebuild_invalidates(tmp_path):
    """A sidecar for 8 shards is rebuilt and saved again under a 4-shard
    mesh; rebuilding the index at the same base deletes the sidecar, and
    the next sharded load builds it anew."""
    import leann_tpu_torch.ops.vamana as vam

    base = str(tmp_path / "documents.leann")
    _build_small_index(base, "vamana")
    meta = IndexMeta.load(meta_path(base))
    load_searcher(base, meta, sharded=True, device=CPU8)
    assert int(np.load(shardfile.shards_path(base))["n_shards"]) == 8
    calls = []
    real = vam.build_vamana

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    vam.build_vamana = counted
    try:
        load_searcher(base, meta, sharded=True, device=CPU8[:4])
        assert len(calls) == 4
        assert int(np.load(shardfile.shards_path(base))["n_shards"]) == 4
        _build_small_index(base, "vamana", seed=1)
        assert not os.path.exists(shardfile.shards_path(base))
        calls.clear()
        load_searcher(base, meta, sharded=True, device=CPU8[:4])
        assert len(calls) == 4 and os.path.exists(shardfile.shards_path(base))
    finally:
        vam.build_vamana = real


def test_init_distributed_noop_single_host(monkeypatch):
    """Without WORLD_SIZE (or with 1) init_distributed is a no-op
    returning False, as the reference's is without its environment."""
    from leann_tpu.parallel import init_distributed as jax_init
    from leann_tpu_torch.parallel import init_distributed

    for var in ("WORLD_SIZE", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    assert jax_init() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()


_DIST_CASE = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from leann_tpu_torch.parallel import (
        ShardedFlatIndex, ShardedGraphIndex, ShardedIvf8Index,
        ShardedIvfIndex, init_distributed, make_mesh)

    def run(mesh):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((999, 32)).astype(np.float32)
        q = x[rng.integers(0, 999, 16)] + 0.05 * rng.standard_normal(
            (16, 32)).astype(np.float32)
        out = {}
        out["flat"] = ShardedFlatIndex(x, mesh, "l2").search(q, k=10)
        g = ShardedGraphIndex(x, mesh, "l2", graph_degree=12, complexity=24,
                              build_wave_size=128)
        out["graph"] = g.search(q, k=10, beam_width=32)
        out["adjacency"] = (g.adjacency_shards, g.medoids_host)
        p = ShardedGraphIndex(x, mesh, "l2", graph_degree=12, engine="pq",
                              qb=8, adjacency_shards=g.adjacency_shards,
                              medoids=g.medoids_host)
        out["pq"] = p.search(q, k=10, beam_width=32)
        ivf = ShardedIvfIndex(x, mesh, "l2", n_clusters=8)
        out["ivf"] = ivf.search(q, k=10, nprobe=4)
        out["ivf_centers"] = (np.concatenate(ivf.centers_host),
                              np.concatenate(ivf.assign_host))
        out["ivf8"] = ShardedIvf8Index(x, mesh, "l2", n_clusters=8).search(
            q, k=10, nprobe=4)
        return {f"{k}{i}": v for k, pair in out.items()
                for i, v in enumerate(pair)}

    if __name__ == "__main__":
        assert init_distributed()
        import torch.distributed as dist
        mesh = make_mesh((1, 2), devices=["cpu"] * 2)
        assert mesh.shape["shard"] == 4 and mesh.process_count == 2
        out = run(mesh)
        if dist.get_rank() == 0:
            np.savez(sys.argv[1], **out)
        dist.destroy_process_group()
""")


def test_init_distributed_two_processes(tmp_path):
    """Two processes joined by gloo, 2 shards each, return the ids and
    scores of one process with 4 shards (flat, graph with its own builds,
    pq, ivf and ivf8), and every process holds all shards' graphs and
    k-means for the sidecar."""
    script = tmp_path / "dist_case.py"
    script.write_text(_DIST_CASE)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = tmp_path / "dist.npz"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(out)], cwd=str(tmp_path),
        env=dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                 WORLD_SIZE="2", RANK=str(rank), PYTHONPATH=REPO,
                 OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
    sys.path.insert(0, str(tmp_path))
    try:
        import dist_case
    finally:
        sys.path.remove(str(tmp_path))
    from leann_tpu_torch.parallel import make_mesh

    want = dist_case.run(make_mesh((1, 4), devices=["cpu"] * 4))
    got = np.load(out)
    assert sorted(got.files) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_dryrun_multichip_matches_reference():
    """The port's dry run passes the reference's assertions on an
    8-device CPU mesh, as `__graft_entry__.dryrun_multichip(8)` does, and
    its exact, IVF and ivf8 ids equal the reference engines' on the same
    corpus."""
    import jax

    import __graft_entry__ as graft
    from leann_tpu import parallel as jp
    from leann_tpu_torch.entry import dryrun_multichip

    graft.dryrun_multichip(8)
    out = dryrun_multichip(8, device="cpu")
    mesh = jp.make_mesh((2, 4), devices=jax.devices()[:8])
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((256, 32)).astype(np.float32)
    queries = corpus[rng.integers(0, 256, 8)]
    for name, ref in (
            ("flat", jp.ShardedFlatIndex(corpus, mesh, metric="l2").search(
                queries, k=5)),
            ("ivf", jp.ShardedIvfIndex(corpus, mesh, metric="l2",
                                       n_clusters=8).search(
                queries, k=5, nprobe=8)),
            ("ivf8", jp.ShardedIvf8Index(corpus, mesh, metric="l2",
                                         n_clusters=8).search(
                queries, k=5, nprobe=8))):
        np.testing.assert_array_equal(out[name][0], ref[0], err_msg=name)
    assert set(out) == {"graph", "flat", "ivf", "ivf8", "pq"}
