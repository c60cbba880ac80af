"""Token store for pruned-index recompute (the port's copy of
`leann_tpu/store/tokens.py`): a fixed-width int32 token matrix.

A pruned index has no stored embeddings; re-embedding needs the passage
text back through the encoder. Passages are tokenized once at build
time into an int32 [N, T] matrix that the traversal uploads to the
device. Attention masks are contiguous prefixes, so only per-row lengths
are stored and the mask is rebuilt as `arange(T) < length`. Cost:
4 * (T + 1) bytes per passage against 4 * D for f32 embeddings.

`<base>.tokens.npz` holds `token_ids` (int32 [N, T]) and `lengths`
(int32 [N]), written by `np.savez_compressed` as the reference writes
it, so an index built by either package loads in the other.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def tokens_path(base: str) -> str:
    return base + ".tokens.npz"


def save_tokens(base: str, token_ids: np.ndarray, attn_mask: np.ndarray) -> None:
    lengths = np.asarray(attn_mask, dtype=np.int32).sum(axis=1).astype(np.int32)
    np.savez_compressed(
        tokens_path(base),
        token_ids=token_ids.astype(np.int32),
        lengths=lengths,
    )


def load_tokens(base: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (token_ids [N, T], attn_mask [N, T]); the mask is rebuilt
    from the stored lengths."""
    with np.load(tokens_path(base), allow_pickle=False) as z:
        token_ids = z["token_ids"]
        lengths = z["lengths"]
    t = token_ids.shape[1]
    attn_mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.int32)
    return token_ids, attn_mask


def tokens_exist(base: str) -> bool:
    return os.path.exists(tokens_path(base))
