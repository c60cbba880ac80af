"""One stream per purpose, all derived from the run's `--seed`.

`--seed` may be any whole number, negative or past 64 bits; each purpose
(corpus, queries, the judged sample) gets its own
64-bit seed from it, so adding a purpose never shifts another's stream.
"""

from __future__ import annotations

import zlib

import numpy as np


def sub_seed(seed: int, purpose: str) -> int:
    """A 64-bit seed for `purpose`, fixed by (`seed`, `purpose`)."""
    words = [int(seed) % (1 << 128), zlib.crc32(purpose.encode())]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, purpose))


def torch_generator(seed: int, purpose: str, device):
    """A `torch.Generator` on `device` seeded for `purpose`."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, purpose))
    return g
