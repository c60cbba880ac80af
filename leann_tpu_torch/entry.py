"""The port's flagship forward step (the contract of the reference's
`__graft_entry__.entry`): encode a query batch with the on-device BERT
encoder, then run one batched beam search over a Vamana graph.

    fn, args = entry()          # on the card; entry(device="cpu") on the CPU
    ids, scores = fn(*args)     # [16, 10] each
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
