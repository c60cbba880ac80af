"""Char-window chunker with word-boundary breaks and overlap.

Behavioral parity with the reference (`src/chunker/simple.rs:8-118`):
sizes are given in "tokens" with 1 token ~= 4 chars, breaks prefer word
boundaries, consecutive chunks overlap, and degenerate inputs can't loop
forever.
"""

from __future__ import annotations

from typing import List

from leann_tpu_torch.chunker import Chunk

CHARS_PER_TOKEN = 4


class SimpleChunker:
    def __init__(self, chunk_size: int = 256, chunk_overlap: int = 128):
        if chunk_overlap >= chunk_size:
            chunk_overlap = max(0, chunk_size // 2)
        self.window = max(chunk_size * CHARS_PER_TOKEN, 1)
        self.overlap = chunk_overlap * CHARS_PER_TOKEN

    def chunk(self, text: str, path: str, start_id: int = 0) -> List[Chunk]:
        text = text.strip()
        if not text:
            return []
        chunks: List[Chunk] = []
        n = len(text)
        start = 0
        index = 0
        while start < n:
            end = min(start + self.window, n)
            # Prefer breaking at a word boundary (search back up to 20% of
            # the window for whitespace).
            if end < n:
                back_limit = max(start + 1, end - self.window // 5)
                cut = end
                while cut > back_limit and not text[cut - 1].isspace():
                    cut -= 1
                if cut > back_limit:
                    end = cut
            piece = text[start:end].strip()
            if piece:
                chunks.append(
                    Chunk(
                        id=f"{path}#{start_id + index}",
                        text=piece,
                        metadata={
                            "source": path,
                            "chunk_index": start_id + index,
                            "chunk_type": "simple",
                        },
                    )
                )
                index += 1
            if end >= n:
                break
            next_start = end - self.overlap
            # Infinite-loop guard: always advance.
            if next_start <= start:
                next_start = start + max(1, self.window - self.overlap)
            start = next_start
        return chunks
