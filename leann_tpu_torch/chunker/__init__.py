"""Chunking layer (L3).

Capabilities mirror the reference (`src/chunker/mod.rs:14-117`):
a `Chunk` record, a strategy enum (simple | ast | auto), a simple
char-window chunker and a structure-aware code chunker, with a
`SmartChunker` that auto-routes code file extensions to the code chunker.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List

__all__ = ["Chunk", "ChunkingStrategy", "SmartChunker", "CODE_EXTENSIONS"]


@dataclass
class Chunk:
    id: str
    text: str
    metadata: Dict[str, Any] = field(default_factory=dict)


class ChunkingStrategy(str, Enum):
    SIMPLE = "simple"
    AST = "ast"
    AUTO = "auto"

    @staticmethod
    def parse(s: str) -> "ChunkingStrategy":
        s = s.strip().lower()
        for strat in ChunkingStrategy:
            if strat.value == s:
                return strat
        raise ValueError(f"unknown chunking strategy: {s!r} (simple|ast|auto)")


# Extensions auto-routed to the code chunker (reference: chunker/mod.rs:83-95)
CODE_EXTENSIONS = {
    "rs", "py", "js", "ts", "jsx", "tsx", "go", "java", "c", "h",
    "cpp", "hpp", "cc", "cs", "rb", "php", "swift", "kt",
}


class SmartChunker:
    """Routes files to the right chunker by strategy + extension."""

    def __init__(
        self,
        chunk_size: int = 256,
        chunk_overlap: int = 128,
        strategy: ChunkingStrategy = ChunkingStrategy.AUTO,
    ):
        from leann_tpu_torch.chunker.simple import SimpleChunker
        from leann_tpu_torch.chunker.code import CodeChunker

        self.strategy = strategy
        self.simple = SimpleChunker(chunk_size, chunk_overlap)
        self.code = CodeChunker(chunk_size, chunk_overlap)

    def chunk(self, text: str, path: str, start_id: int = 0) -> List[Chunk]:
        ext = path.rsplit(".", 1)[-1].lower() if "." in path else ""
        use_code = self.strategy == ChunkingStrategy.AST or (
            self.strategy == ChunkingStrategy.AUTO and ext in CODE_EXTENSIONS
        )
        if use_code:
            return self.code.chunk(text, path, start_id)
        return self.simple.chunk(text, path, start_id)
