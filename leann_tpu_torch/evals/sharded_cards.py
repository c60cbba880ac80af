"""Sharded search across four cards (`leann_tpu_torch.parallel`).

(A) One process with a (1, 4) mesh over cuda:0-3 builds four shards of
the sift mixture (1M x 128 l2; R=48, L=80, alpha 1.2, wave 8192 per
shard) and is held against the same shards on cuda:0 alone (ids and
scores equal), with recall@10 at beam 64 and device ms per batch of 2048
by CUDA events for both layouts, in turns. (B) Four processes joined by
`nccl` (`init_distributed`, one card each through LOCAL_RANK) load the
saved subgraphs and search; rank 0's ids and scores must equal (A)'s.
`--cpu` rehearses both on the CPU (gloo, 8,000 rows). Needs four cards:

    python -m leann_tpu_torch.evals.sharded_cards
    python -m leann_tpu_torch.evals.sharded_cards --cpu

Run from the repository root (it imports `chip_smoke` for the corpus
generator, the recall and the timing helpers); results print as JSON
lines. The saved subgraphs (192 MB at 1M) go to a temporary directory
that the workers share and that is removed at the end.
"""
import json, os, subprocess, sys, time
sys.path.insert(0, os.getcwd())
import numpy as np, torch

CPU = "--cpu" in sys.argv
N = 8_000 if CPU else 1_000_000
OUT = os.environ.get("SHARDED_CARDS_DIR", "")


def corpus():
    import chip_smoke as cs
    pool = cs.make_corpus(np.random.default_rng(0), N + 1024, 128, 1024)
    return pool[:N], pool[N:]


def worker():
    from leann_tpu_torch.parallel import (
        ShardedFlatIndex, ShardedGraphIndex, init_distributed, make_mesh)
    assert init_distributed()
    import torch.distributed as dist
    x, q = corpus()
    art = np.load(f"{OUT}/graph.npz")
    mesh = make_mesh(devices=["cpu"] if CPU else None)
    t0 = time.perf_counter()
    g = ShardedGraphIndex(x, mesh, "l2", graph_degree=48,
                          engine="fused" if CPU else "auto",
                          adjacency_shards=art["adj"], medoids=art["med"])
    fi, fs = ShardedFlatIndex(x, mesh, "l2").search(q, k=10)
    gi, gs = g.search(q, k=10, beam_width=64)
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "engine": g.engine, "devices": [str(d) for d in mesh.grid.ravel()],
           "shards": mesh.shape["shard"], "s": time.perf_counter() - t0}
    if dist.get_rank() == 0:
        np.savez(f"{OUT}/nccl.npz", fi=fi, fs=fs, gi=gi, gs=gs)
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def main():
    import shutil
    import tempfile

    global OUT
    OUT = tempfile.mkdtemp(prefix="sharded_cards_")
    try:
        run()
    finally:
        shutil.rmtree(OUT, ignore_errors=True)


def run():
    import chip_smoke as cs
    from leann_tpu_torch.ops.distance import exact_topk
    from leann_tpu_torch.parallel import (
        ShardedFlatIndex, ShardedGraphIndex, make_mesh)
    if not CPU:
        print(cs.smi(), torch.cuda.device_count(), flush=True)
        from leann_tpu_torch.ops import _cuda
        _cuda.build(("fused_beam",))
    devs = (["cpu"] * 4 if CPU else [f"cuda:{i}" for i in range(4)])
    one = ["cpu"] * 4 if CPU else ["cuda:0"] * 4
    x, q = corpus()
    oracle = exact_topk(q, x, 10, metric="l2", device="cpu" if CPU else "cuda")[1]
    t0 = time.perf_counter()
    kw = dict(graph_degree=48, complexity=80, alpha=1.2, build_wave_size=8192)
    if CPU:
        kw.update(engine="fused")
    g4 = ShardedGraphIndex(x, make_mesh((1, 4), devices=devs), "l2", **kw)
    build_s = time.perf_counter() - t0
    np.savez(f"{OUT}/graph.npz", adj=g4.adjacency_shards, med=g4.medoids_host)
    g1 = ShardedGraphIndex(x, make_mesh((1, 4), devices=one), "l2",
                           graph_degree=48, engine=kw.get("engine", "auto"),
                           adjacency_shards=g4.adjacency_shards,
                           medoids=g4.medoids_host)
    a = g4.search(q, k=10, beam_width=64)
    b = g1.search(q, k=10, beam_width=64)
    f4 = ShardedFlatIndex(x, make_mesh((1, 4), devices=devs), "l2").search(q, k=10)
    row = {"n": N, "engines": [g4.engine, g1.engine], "build_s": build_s,
           "recall10": cs.recall_at(a[0], oracle),
           "four_equal_one": bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])),
           "flat_recall10": cs.recall_at(f4[0], oracle)}
    if not CPU:
        windows = [torch.from_numpy(cs.noisy_rows(x, (4, 2048), 1000 + w)).to("cuda:0")
                   for w in range(3)]
        for name, idx in (("four_cards", g4), ("one_card", g1)):
            per, qps = cs.qps_windows(torch, lambda qq: idx.search_device(
                qq, k=10, beam_width=64), windows)
            row[name] = {"ms_per_batch": per, "qps_mean": float(np.mean(qps))}
        for name, idx in (("one_card_2", g1), ("four_cards_2", g4)):
            per, qps = cs.qps_windows(torch, lambda qq: idx.search_device(
                qq, k=10, beam_width=64), windows)
            row[name] = {"ms_per_batch": per, "qps_mean": float(np.mean(qps))}
        row["profile_four"] = cs.profile(torch, lambda: [g4.search_device(
            qq, k=10, beam_width=64) for qq in windows[1]])
    print(json.dumps(row), flush=True)
    del g1, g4
    if not CPU:
        torch.cuda.empty_cache()
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker"] + (["--cpu"] if CPU else []),
        env=dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                 WORLD_SIZE="4", RANK=str(r), LOCAL_RANK=str(r),
                 OMP_NUM_THREADS="2", SHARDED_CARDS_DIR=OUT))
        for r in range(4)]
    rcs = [p.wait(timeout=900) for p in procs]
    got = np.load(f"{OUT}/nccl.npz")
    print(json.dumps({"worker_rcs": rcs,
                      "graph_ids_equal": bool(np.array_equal(got["gi"], a[0])),
                      "graph_scores_equal": bool(np.array_equal(got["gs"], a[1])),
                      "flat_ids_equal": bool(np.array_equal(got["fi"], f4[0])),
                      "flat_scores_max_diff": float(np.abs(got["fs"] - f4[1]).max())}),
          flush=True)


if __name__ == "__main__":
    worker() if "--worker" in sys.argv else main()
