"""PQ codebook/code sidecar on disk (`<base>.pq.npz`), a copy of
`leann_tpu/store/pqfile.py`: the bytes are the same, so a sidecar written
by either package loads in the other.

Training codebooks and encoding the corpus is the expensive part of
bringing up the PQ graph engine; the artifacts are deterministic
functions of the corpus, so they persist beside the index. `n` and
`metric` are stored and validated on load: a rebuild at the same base
must never silently serve stale codes.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def pq_path(base: str) -> str:
    return base + ".pq.npz"


def save_pq(
    base: str,
    books: np.ndarray,    # [m, ksub, dsub] f32
    codes: np.ndarray,    # [N, m] uint8
    n: int,
    metric: str,
    rot: Optional[np.ndarray] = None,  # [D, D] OPQ rotation (codes are
                                       # rotated-frame when present)
) -> None:
    extra = {}
    if rot is not None:
        extra["rot"] = np.asarray(rot, np.float32)
    np.savez_compressed(
        pq_path(base),
        books=np.asarray(books, np.float32),
        codes=np.asarray(codes, np.uint8),
        n=np.int64(n),
        metric=np.str_(metric),
        **extra,
    )


def load_pq(
    base: str, n: int, metric: str, want_rot: bool = False
) -> Optional[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]]:
    """Returns (books, codes, rot-or-None) or None when absent/stale.

    A cache whose rotated-ness disagrees with `want_rot` is stale: the
    codes live in a different frame than the engine is about to build
    its LUTs for, so reusing them would silently corrupt every ADC
    score.
    """
    path = pq_path(base)
    if not os.path.exists(path):
        return None
    try:
        z = np.load(path)
        if int(z["n"]) != n or str(z["metric"]) != metric:
            return None
        rot = z["rot"] if "rot" in z.files else None
        if want_rot != (rot is not None):
            return None
        return z["books"], z["codes"], rot
    except Exception:
        return None


def invalidate_pq(base: str) -> None:
    path = pq_path(base)
    if os.path.exists(path):
        os.remove(path)
