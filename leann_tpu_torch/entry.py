"""The port's flagship forward step (the contract of the reference's
`__graft_entry__.entry`): encode a query batch with the on-device BERT
encoder, then run one batched beam search over a Vamana graph.

    fn, args = entry()          # on the card; entry(device="cpu") on the CPU
    ids, scores = fn(*args)     # [16, 10] each

`dryrun_multichip(n)` runs the sharded engines on an n-device mesh (the
reference's `__graft_entry__.dryrun_multichip`).
"""

from __future__ import annotations

import numpy as np
import torch

from leann_tpu_torch.device import DeviceLike, resolve_device


def entry(device: DeviceLike = None):
    """Returns (forward_step, example_args) on `device` (default cuda). A
    tiny encoder embeds 512 texts, `build_vamana` (R=16, L=32, ip, wave
    128) links them, and `forward_step(params, token_ids, attn_mask,
    vecs, adj, sq)` is `bert_forward` then `beam_search_batch` (beam 32,
    96 hops), returning the first 10 ids and scores of each query."""
    from leann_tpu_torch.models.bert import (
        BertConfig, BertEncoder, bert_forward,
    )
    from leann_tpu_torch.ops.beam import beam_search_batch
    from leann_tpu_torch.ops.vamana import build_vamana

    dev = resolve_device(device)
    encoder = BertEncoder(config=BertConfig.tiny(), device=dev)
    texts = [f"doc {i} topic {i % 13}" for i in range(512)]
    vectors = encoder.embed(texts)
    adjacency, medoid = build_vamana(
        vectors, graph_degree=16, complexity=32, metric="ip", wave_size=128,
        device=dev,
    )
    n, d = vectors.shape
    vecs = torch.from_numpy(
        np.concatenate([vectors, np.zeros((1, d), np.float32)])).to(dev)
    adj = torch.from_numpy(
        np.concatenate([adjacency, np.full((1, 16), n, np.int32)])).to(dev)
    sq = (vecs * vecs).sum(dim=1)
    config = encoder.config

    def forward_step(params, token_ids, attn_mask, vecs, adj, sq):
        with torch.no_grad():
            q = bert_forward(params, token_ids, attn_mask, config)
            exclude = torch.full((q.shape[0],), -1, dtype=torch.int32,
                                 device=q.device)
            ids, scores = beam_search_batch(
                q, vecs, adj, sq, int(medoid), exclude,
                beam_width=32, max_iters=96, metric="ip",
            )
        return ids[:, :10], scores[:, :10]

    tok, mask = encoder.tokenize_corpus(
        [f"query {i} topic {i % 13}" for i in range(16)], max_length=32
    )
    example_args = (
        encoder.params, torch.from_numpy(tok).to(dev),
        torch.from_numpy(mask).to(dev), vecs, adj, sq,
    )
    return forward_step, example_args


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> dict:
    """The sharded pipeline on an n-device mesh (the contract of the
    reference's `__graft_entry__.dryrun_multichip`): per-shard Vamana
    builds and graph search, exact, IVF, ivf8 and PQ-graph search, with
    the reference's assertions. `device=None` lays the mesh over the CUDA
    devices (repeating them when there are fewer than n); a device given
    is repeated n times, e.g. `device="cpu"`. Returns each engine's
    (ids, scores)."""
    from leann_tpu_torch.parallel import (
        ShardedFlatIndex, ShardedGraphIndex, ShardedIvf8Index,
        ShardedIvfIndex, make_mesh,
    )

    if device is None:
        resolve_device(None)
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n_devices)]
    else:
        devices = [resolve_device(device)] * n_devices

    # a dp x shard mesh when it divides; otherwise pure corpus sharding
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh = make_mesh((2, n_devices // 2), devices=devices)
    else:
        mesh = make_mesh((1, n_devices), devices=devices)

    rng = np.random.default_rng(0)
    n, d = 64 * mesh.shape["shard"], 32
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = corpus[rng.integers(0, n, 8)]
    out = {}

    graph_index = ShardedGraphIndex(
        corpus, mesh, metric="l2", graph_degree=8, complexity=16,
        build_wave_size=32,
    )
    idx, scores = out["graph"] = graph_index.search(queries, k=5,
                                                    beam_width=16)
    assert idx.shape == (8, 5) and np.isfinite(scores).all()

    flat_index = ShardedFlatIndex(corpus, mesh, metric="l2")
    fidx, _ = out["flat"] = flat_index.search(queries, k=5)
    assert fidx.shape == (8, 5)
    # the two engines must agree on the nearest neighbour (self)
    assert (idx[:, 0] == fidx[:, 0]).mean() >= 0.9

    ivf_index = ShardedIvfIndex(corpus, mesh, metric="l2", n_clusters=8)
    iidx, _ = out["ivf"] = ivf_index.search(queries, k=5, nprobe=8)
    assert iidx.shape == (8, 5)
    assert (iidx[:, 0] == fidx[:, 0]).mean() >= 0.9

    ivf8_index = ShardedIvf8Index(corpus, mesh, metric="l2", n_clusters=8)
    i8idx, _ = out["ivf8"] = ivf8_index.search(queries, k=5, nprobe=8)
    assert i8idx.shape == (8, 5)
    assert (i8idx[:, 0] == fidx[:, 0]).mean() >= 0.9

    # the PQ-record engine on the same mesh, d=128 so that m=16 x 8-dim
    # subspaces engage
    pq_n = 128 * mesh.shape["shard"]
    pq_corpus = (rng.standard_normal((pq_n, 128)) * 0.5).astype(np.float32)
    pq_queries = pq_corpus[rng.integers(0, pq_n, 8)]
    pq_index = ShardedGraphIndex(
        pq_corpus, mesh, metric="l2", graph_degree=12, complexity=24,
        build_wave_size=64, engine="pq", qb=8,
    )
    assert pq_index.engine == "pq"
    pidx, pscores = out["pq"] = pq_index.search(pq_queries, k=5,
                                                beam_width=16)
    assert pidx.shape == (8, 5) and np.isfinite(pscores).all()
    # the exact self-neighbour must survive PQ navigation + exact rescore
    assert (pidx[:, 0] == np.array(
        [np.argmax(pq_corpus @ q - 0.5 * (pq_corpus * pq_corpus).sum(1))
         for q in pq_queries])).mean() >= 0.75
    print(
        f"dryrun_multichip OK: mesh={dict(mesh.shape)} "
        f"graph+flat+ivf+ivf8+pq sharded search ran on {n_devices} devices"
    )
    return out
