"""Seeded vector data, made on the device in a few large calls.

`mixture` is the distribution of `make_corpus` in the port's
`evals/corpus_cache.py` (1024 Gaussian centres at 4x, unit noise, each
row's centre drawn uniformly), drawn with a `torch.Generator` on the
device from `--seed` instead of one numpy stream seeded 0. `near_rows`
is the bench's query draw: a corpus row plus unit noise.
"""

from __future__ import annotations

from benchmark.data.seeds import torch_generator


def mixture(n: int, d: int, clusters: int, center_scale: float, seed: int,
            device, chunk: int = 1 << 20):
    """[n, d] float32 on `device`: centres at `center_scale` x N(0, 1)
    plus N(0, 1) noise."""
    import torch

    g = torch_generator(seed, "corpus", device)
    centers = torch.randn((clusters, d), generator=g, device=device)
    centers *= center_scale
    assign = torch.randint(0, clusters, (n,), generator=g, device=device)
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        out[s:e] = centers[assign[s:e]] + torch.randn(
            (e - s, d), generator=g, device=device)
    return out


def near_rows(corpus, count: int, seed: int, purpose: str):
    """[count, d] float32 queries on the corpus's device: a uniformly
    drawn corpus row plus N(0, 1) noise each."""
    import torch

    g = torch_generator(seed, purpose, corpus.device)
    rows = torch.randint(0, corpus.shape[0], (count,), generator=g,
                         device=corpus.device)
    return corpus[rows] + torch.randn((count, corpus.shape[1]), generator=g,
                                      device=corpus.device)

