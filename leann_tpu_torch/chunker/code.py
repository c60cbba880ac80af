"""Structure-aware code chunker.

Like the reference's regex-"AST" chunker (`src/chunker/ast.rs:28-407`):
per-language regexes find block starts (functions, classes, structs, ...);
block ends are found by brace counting (C-family) or indentation (Python/
Ruby); gaps between blocks become "context" chunks; oversize blocks are
split by lines with overlap; unknown languages fall back to the simple
chunker. Metadata carries block type/name/language/line span.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from leann_tpu_torch.chunker import Chunk
from leann_tpu_torch.chunker.simple import SimpleChunker, CHARS_PER_TOKEN

# language -> (uses_braces, [(block_type, compiled regex with name group)])
_LANG_PATTERNS = {
    "rust": (True, [
        ("function", re.compile(r"^\s*(?:pub(?:\([^)]*\))?\s+)?(?:async\s+)?(?:unsafe\s+)?fn\s+(\w+)")),
        ("struct", re.compile(r"^\s*(?:pub(?:\([^)]*\))?\s+)?struct\s+(\w+)")),
        ("enum", re.compile(r"^\s*(?:pub(?:\([^)]*\))?\s+)?enum\s+(\w+)")),
        ("trait", re.compile(r"^\s*(?:pub(?:\([^)]*\))?\s+)?trait\s+(\w+)")),
        ("impl", re.compile(r"^\s*impl(?:<[^>]*>)?\s+(\w+)")),
    ]),
    "python": (False, [
        ("function", re.compile(r"^\s*(?:async\s+)?def\s+(\w+)")),
        ("class", re.compile(r"^\s*class\s+(\w+)")),
    ]),
    "javascript": (True, [
        ("function", re.compile(r"^\s*(?:export\s+)?(?:async\s+)?function\s*\*?\s*(\w+)")),
        ("class", re.compile(r"^\s*(?:export\s+)?class\s+(\w+)")),
        ("arrow", re.compile(r"^\s*(?:export\s+)?(?:const|let|var)\s+(\w+)\s*=\s*(?:async\s+)?\(")),
    ]),
    "typescript": (True, [
        ("function", re.compile(r"^\s*(?:export\s+)?(?:async\s+)?function\s*\*?\s*(\w+)")),
        ("class", re.compile(r"^\s*(?:export\s+)?(?:abstract\s+)?class\s+(\w+)")),
        ("interface", re.compile(r"^\s*(?:export\s+)?interface\s+(\w+)")),
        ("arrow", re.compile(r"^\s*(?:export\s+)?(?:const|let|var)\s+(\w+)\s*=\s*(?:async\s+)?\(")),
    ]),
    "go": (True, [
        ("function", re.compile(r"^\s*func\s+(?:\([^)]*\)\s+)?(\w+)")),
        ("type", re.compile(r"^\s*type\s+(\w+)\s+(?:struct|interface)")),
    ]),
    "java": (True, [
        ("class", re.compile(r"^\s*(?:public|private|protected)?\s*(?:static\s+)?(?:final\s+)?(?:class|interface|enum)\s+(\w+)")),
        ("method", re.compile(r"^\s*(?:public|private|protected)\s+(?:static\s+)?[\w<>\[\]]+\s+(\w+)\s*\(")),
    ]),
    "c": (True, [
        ("function", re.compile(r"^[\w\*]+\s+\*?(\w+)\s*\([^;]*$")),
        ("struct", re.compile(r"^\s*(?:typedef\s+)?struct\s+(\w+)")),
    ]),
    "cpp": (True, [
        ("function", re.compile(r"^[\w\*:<>~]+\s+[\*&]?([\w:]+)\s*\([^;]*$")),
        ("class", re.compile(r"^\s*(?:class|struct)\s+(\w+)")),
    ]),
    "ruby": (False, [
        ("method", re.compile(r"^\s*def\s+(\w+)")),
        ("class", re.compile(r"^\s*class\s+(\w+)")),
        ("module", re.compile(r"^\s*module\s+(\w+)")),
    ]),
    "csharp": (True, [
        ("class", re.compile(r"^\s*(?:public|private|protected|internal)?\s*(?:static\s+)?(?:class|interface|struct)\s+(\w+)")),
        ("method", re.compile(r"^\s*(?:public|private|protected|internal)\s+(?:static\s+)?[\w<>\[\]]+\s+(\w+)\s*\(")),
    ]),
}

_EXT_TO_LANG = {
    "rs": "rust", "py": "python",
    "js": "javascript", "jsx": "javascript",
    "ts": "typescript", "tsx": "typescript",
    "go": "go", "java": "java",
    "c": "c", "h": "c",
    "cpp": "cpp", "hpp": "cpp", "cc": "cpp",
    "cs": "csharp", "rb": "ruby",
}


class CodeChunker:
    def __init__(self, chunk_size: int = 256, chunk_overlap: int = 128):
        self.max_chars = max(chunk_size * CHARS_PER_TOKEN, 64)
        self.overlap_lines = 3
        self.simple = SimpleChunker(chunk_size, chunk_overlap)

    def chunk(self, text: str, path: str, start_id: int = 0) -> List[Chunk]:
        ext = path.rsplit(".", 1)[-1].lower() if "." in path else ""
        lang = _EXT_TO_LANG.get(ext)
        if lang is None:
            return self.simple.chunk(text, path, start_id)
        blocks = self._find_blocks(text, lang)
        if not blocks:
            return self.simple.chunk(text, path, start_id)
        return self._emit(text, path, lang, blocks, start_id)

    # (start_line, end_line, block_type, name) 0-based inclusive
    def _find_blocks(self, text: str, lang: str) -> List[Tuple[int, int, str, str]]:
        uses_braces, patterns = _LANG_PATTERNS[lang]
        lines = text.split("\n")
        blocks: List[Tuple[int, int, str, str]] = []
        for i, line in enumerate(lines):
            for block_type, pat in patterns:
                m = pat.match(line)
                if m:
                    end = (
                        self._brace_end(lines, i)
                        if uses_braces
                        else self._indent_end(lines, i)
                    )
                    if end is not None and end >= i:
                        blocks.append((i, end, block_type, m.group(1)))
                    break
        # Drop blocks fully contained in an earlier block (keep outermost).
        blocks.sort(key=lambda b: (b[0], -b[1]))
        result: List[Tuple[int, int, str, str]] = []
        last_end = -1
        for b in blocks:
            if b[0] > last_end:
                result.append(b)
                last_end = b[1]
        return result

    @staticmethod
    def _brace_end(lines: List[str], start: int) -> Optional[int]:
        depth = 0
        opened = False
        for j in range(start, min(len(lines), start + 4000)):
            for ch in lines[j]:
                if ch == "{":
                    depth += 1
                    opened = True
                elif ch == "}":
                    depth -= 1
                    if opened and depth <= 0:
                        return j
            if not opened and j > start + 4:
                # Declaration with no body (e.g. prototype) — single line.
                return start
        return len(lines) - 1 if opened else start

    @staticmethod
    def _indent_end(lines: List[str], start: int) -> Optional[int]:
        def indent_of(s: str) -> int:
            return len(s) - len(s.lstrip())

        base = indent_of(lines[start])
        end = start
        for j in range(start + 1, len(lines)):
            s = lines[j]
            if not s.strip():
                continue
            if indent_of(s) <= base:
                break
            end = j
        return end

    def _emit(
        self,
        text: str,
        path: str,
        lang: str,
        blocks: List[Tuple[int, int, str, str]],
        start_id: int,
    ) -> List[Chunk]:
        lines = text.split("\n")
        chunks: List[Chunk] = []
        next_index = start_id
        cursor = 0  # next unemitted line

        def emit(body_lines: List[str], meta: dict) -> None:
            nonlocal next_index
            body = "\n".join(body_lines).strip()
            if not body:
                return
            if len(body) > self.max_chars:
                # Oversize: split by lines with a few lines of overlap.
                step_chars = self.max_chars
                piece: List[str] = []
                size = 0
                start_ln = meta.get("start_line", 0)
                ln = start_ln
                for row in body_lines:
                    piece.append(row)
                    size += len(row) + 1
                    if size >= step_chars:
                        sub = dict(meta)
                        sub["start_line"] = ln
                        sub["end_line"] = ln + len(piece) - 1
                        sub["chunk_index"] = next_index
                        chunks.append(
                            Chunk(f"{path}#{next_index}", "\n".join(piece).strip(), sub)
                        )
                        next_index += 1
                        keep = piece[-self.overlap_lines :]
                        ln = ln + len(piece) - len(keep)
                        piece = list(keep)
                        size = sum(len(r) + 1 for r in piece)
                if piece and size > sum(len(r) + 1 for r in piece[: self.overlap_lines]) - 1:
                    sub = dict(meta)
                    sub["start_line"] = ln
                    sub["end_line"] = ln + len(piece) - 1
                    sub["chunk_index"] = next_index
                    chunks.append(
                        Chunk(f"{path}#{next_index}", "\n".join(piece).strip(), sub)
                    )
                    next_index += 1
            else:
                meta = dict(meta)
                meta["chunk_index"] = next_index
                chunks.append(Chunk(f"{path}#{next_index}", body, meta))
                next_index += 1

        for (bstart, bend, btype, name) in blocks:
            if bstart > cursor:
                # Gap between blocks -> context chunk.
                emit(
                    lines[cursor:bstart],
                    {
                        "source": path,
                        "chunk_type": "context",
                        "language": lang,
                        "start_line": cursor,
                        "end_line": bstart - 1,
                    },
                )
            emit(
                lines[bstart : bend + 1],
                {
                    "source": path,
                    "chunk_type": "code",
                    "block_type": btype,
                    "name": name,
                    "language": lang,
                    "start_line": bstart,
                    "end_line": bend,
                },
            )
            cursor = max(cursor, bend + 1)
        if cursor < len(lines):
            emit(
                lines[cursor:],
                {
                    "source": path,
                    "chunk_type": "context",
                    "language": lang,
                    "start_line": cursor,
                    "end_line": len(lines) - 1,
                },
            )
        return chunks
