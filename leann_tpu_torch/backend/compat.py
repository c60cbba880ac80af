"""Foreign-index detection (a copy of `leann_tpu/backend/compat.py`, with
the usearch sniff of `leann_tpu/backend/usearch_import.py:96-115`).

A `.index` file produced by Python LEANN (FAISS) or leann-rs (usearch)
cannot be loaded by this engine: detect the magic bytes and emit rebuild
instructions instead of a cryptic parse failure. The messages are the
reference's, word for word.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

_FAISS_MAGICS = (b"IxFI", b"IxF2", b"IxFl", b"IwFl", b"CSR\x00", b"HNSW")

MAGIC = b"usearch"
_HEAD_BYTES = 64


def looks_like_usearch(path: str) -> bool:
    """Cheap sniff: magic at offset 0 (exclude_vectors) or at the end of
    a plausible u32 vector-matrix section."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(8)
            if head[:7] == MAGIC:
                return True
            if len(head) < 8:
                return False
            rows, bpv = struct.unpack("<II", head)
            off = 8 + rows * bpv
            if off + _HEAD_BYTES > size:
                return False
            f.seek(off)
            return f.read(7) == MAGIC
    except OSError:
        return False


def sniff_foreign_index(index_dir: str, base_name: str = "documents.leann") -> Optional[str]:
    """Returns a human-readable diagnosis if the dir holds a foreign
    binary index, else None."""
    path = os.path.join(index_dir, base_name + ".index")
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            head = f.read(8)
    except OSError:
        return None
    if any(head.startswith(m) for m in _FAISS_MAGICS) or head[:2] == b"Ix":
        kind = "FAISS (Python LEANN)"
    else:
        if looks_like_usearch(path):
            return (
                f"Found a usearch (leann-rs) binary index at {path}. "
                "Its embedded vectors can be imported directly — no "
                "re-embedding needed:\n"
                "  leann-tpu reindex <name>\n"
                "(backend/usearch_import.py parses the usearch v2 "
                "format; falls back to `build --force` if parsing fails)"
            )
        kind = "usearch (leann-rs)"
    return (
        f"Found a {kind} binary index at {path}. This TPU engine uses its "
        "own graph/ivf formats; the passages/ids/meta files are compatible, "
        "so rebuild the ANN structure with:\n"
        "  leann-tpu build <name> --docs <dir> --force"
    )
