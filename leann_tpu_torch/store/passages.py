"""Passage store: JSONL + JSON byte-offset sidecar.

Same artifact contract as the reference (`src/index/passages.rs:11-169`):
one JSON object per line in `<base>.passages.jsonl`, random access via a
`{id: byte_offset}` map persisted as JSON (`<base>.passages.idx.json`) so
indexes interoperate with Python LEANN / leann-rs.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional


@dataclass
class Passage:
    id: str
    text: str
    metadata: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(
            {"id": self.id, "text": self.text, "metadata": self.metadata},
            ensure_ascii=False,
        )

    @staticmethod
    def from_json(line: str) -> "Passage":
        obj = json.loads(line)
        return Passage(
            id=str(obj["id"]),
            text=obj.get("text", ""),
            metadata=obj.get("metadata") or {},
        )


def passages_path(base: str) -> str:
    return base + ".passages.jsonl"


def offsets_path(base: str) -> str:
    return base + ".passages.idx.json"


def ids_path(base: str) -> str:
    return base + ".ids.txt"


class PassageStoreWriter:
    """Streaming writer: appends passages, tracks byte offsets."""

    def __init__(self, base: str, append: bool = False):
        self.base = base
        mode = "ab" if append else "wb"
        self._offsets: Dict[str, int] = {}
        if append and os.path.exists(offsets_path(base)):
            with open(offsets_path(base), "r", encoding="utf-8") as f:
                self._offsets = {str(k): int(v) for k, v in json.load(f).items()}
        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
        self._f = open(passages_path(base), mode)
        self._pos = self._f.tell() if append else 0

    def add(self, passage: Passage) -> None:
        data = (passage.to_json() + "\n").encode("utf-8")
        self._offsets[passage.id] = self._pos
        self._f.write(data)
        self._pos += len(data)

    def __len__(self) -> int:
        return len(self._offsets)

    def finish(self) -> None:
        self._f.flush()
        self._f.close()
        # JSON (not pickle) for cross-implementation compat, mirroring the
        # reference's explicit choice (src/index/passages.rs:153).
        with open(offsets_path(self.base), "w", encoding="utf-8") as f:
            json.dump(self._offsets, f)

    def __enter__(self) -> "PassageStoreWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


class PassageStore:
    """Random-access reader over the JSONL file via the offset map."""

    def __init__(self, base: str):
        self.base = base
        with open(offsets_path(base), "r", encoding="utf-8") as f:
            self.offsets: Dict[str, int] = {
                str(k): int(v) for k, v in json.load(f).items()
            }
        self._f = open(passages_path(base), "rb")

    def __len__(self) -> int:
        return len(self.offsets)

    def __contains__(self, pid: str) -> bool:
        return pid in self.offsets

    def get(self, pid: str) -> Optional[Passage]:
        off = self.offsets.get(pid)
        if off is None:
            return None
        return Passage.from_json(self._read_line_at(off).decode("utf-8"))

    def _read_line_at(self, off: int) -> bytes:
        # Positional pread, NOT seek+readline: the store is shared by
        # every ThreadingHTTPServer handler thread, and interleaved
        # seek()/readline() on one file object serves garbled JSON
        # under concurrency (found by evals/hybrid_latency.py: ~15
        # malformed-passage 500s in a 20s window at 32 clients).
        # pread is atomic w.r.t. the fd offset, so no lock is needed.
        fd = self._f.fileno()
        chunks = []
        pos = off
        while True:
            buf = os.pread(fd, 1 << 16, pos)
            if not buf:
                break
            nl = buf.find(b"\n")
            if nl >= 0:
                chunks.append(buf[:nl])
                break
            chunks.append(buf)
            pos += len(buf)
        return b"".join(chunks)

    def iter_all(self) -> Iterator[Passage]:
        """Sequential scan in file order (fast path for BM25/recompute).

        Uses its own file handle so a concurrent scan (BM25 sidecar
        rebuild, reindex) never perturbs get() readers."""
        with open(passages_path(self.base), "rb") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield Passage.from_json(line.decode("utf-8"))

    def close(self) -> None:
        self._f.close()


def write_ids(base: str, ids: List[str]) -> None:
    """Newline-separated string ids; line number = integer ANN id
    (reference: src/index/builder.rs:101-103)."""
    with open(ids_path(base), "w", encoding="utf-8") as f:
        for pid in ids:
            f.write(pid + "\n")


def read_ids(base: str) -> List[str]:
    with open(ids_path(base), "r", encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f if line.strip()]
