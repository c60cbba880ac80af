"""Minimal pure-Python PDF text extraction (no third-party deps).

The reference bundles the pdf-extract crate so `leann build` ingests PDFs
out of the box (`src/cli/build.rs:631-661`). This environment has no
pypdf, so this module provides the fallback: decompress FlateDecode
content streams with zlib and collect the text-showing operators
(Tj, TJ, ' and ") from BT..ET blocks.

Scope (deliberate): handles the overwhelmingly common case — Flate or
uncompressed content streams, literal `(...)`/hex `<...>` strings in
simple (non-CID) encodings. PDFs using 2-byte CID font CMaps come out
garbled; callers should prefer pypdf when it is installed (the loader
does). This mirrors the reference's own limits: pdf-extract also fails
on many CID-keyed PDFs.
"""

from __future__ import annotations

import re
import zlib
from typing import List

_STREAM_RE = re.compile(rb"<<(.*?)>>\s*stream\r?\n", re.DOTALL)
# text-showing ops inside a content stream
_TJ_RE = re.compile(
    rb"(\((?:[^()\\]|\\.)*\)|<[0-9A-Fa-f\s]*>)\s*(Tj|'|\")"
)
_TJ_ARRAY_RE = re.compile(rb"\[((?:[^][\\]|\\.)*)\]\s*TJ", re.DOTALL)
_STR_RE = re.compile(rb"\((?:[^()\\]|\\.)*\)|<[0-9A-Fa-f\s]*>|(-?\d+(?:\.\d+)?)")
_NEWLINE_OP_RE = re.compile(rb"(T\*|TD|Td|ET)")

_ESCAPES = {
    b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b"\b", b"f": b"\f",
    b"(": b"(", b")": b")", b"\\": b"\\",
}


def _decode_literal(raw: bytes) -> bytes:
    """Decode a PDF literal string's escapes; raw excludes the parens."""
    out = bytearray()
    i = 0
    while i < len(raw):
        c = raw[i : i + 1]
        if c == b"\\" and i + 1 < len(raw):
            nxt = raw[i + 1 : i + 2]
            if nxt in _ESCAPES:
                out += _ESCAPES[nxt]
                i += 2
                continue
            if nxt.isdigit():  # octal \ddd (1-3 digits)
                j = i + 1
                oct_digits = b""
                while j < len(raw) and len(oct_digits) < 3 and raw[j : j + 1].isdigit():
                    oct_digits += raw[j : j + 1]
                    j += 1
                out.append(int(oct_digits, 8) & 0xFF)
                i = j
                continue
            i += 2  # line continuation or unknown escape: drop backslash
            continue
        out += c
        i += 1
    return bytes(out)


def _decode_pdf_string(tok: bytes) -> str:
    if tok.startswith(b"("):
        data = _decode_literal(tok[1:-1])
    else:  # <hex>
        hexstr = re.sub(rb"\s", b"", tok[1:-1])
        if len(hexstr) % 2:
            hexstr += b"0"
        data = bytes.fromhex(hexstr.decode("ascii"))
    text = data.decode("latin-1", errors="replace")
    # CID-coded strings decode to mostly control chars; drop those
    printable = sum(ch.isprintable() or ch in "\n\r\t" for ch in text)
    if text and printable / len(text) < 0.6:
        return ""
    return text


def _extract_from_content(content: bytes) -> str:
    parts: List[str] = []

    # interleave: walk the stream once, emitting strings in order and
    # newlines at line-movement operators
    pos = 0
    events = []
    for m in _TJ_RE.finditer(content):
        events.append((m.start(), "str", m.group(1)))
    for m in _TJ_ARRAY_RE.finditer(content):
        events.append((m.start(), "arr", m.group(1)))
    for m in _NEWLINE_OP_RE.finditer(content):
        events.append((m.start(), "nl", b""))
    events.sort(key=lambda e: e[0])

    for pos, kind, payload in events:
        if kind == "str":
            parts.append(_decode_pdf_string(payload))
        elif kind == "arr":
            for sm in _STR_RE.finditer(payload):
                tok = sm.group(0)
                if tok.startswith((b"(", b"<")):
                    parts.append(_decode_pdf_string(tok))
                elif sm.group(1) is not None:
                    # big negative kerning = inter-word gap
                    try:
                        if float(sm.group(1)) < -150:
                            parts.append(" ")
                    except ValueError:
                        pass
        else:
            if parts and not parts[-1].endswith("\n"):
                parts.append("\n")
    return "".join(parts)


def extract_pdf_text(path: str) -> str:
    """Best-effort text from a PDF file. Returns '' when nothing could
    be extracted (encrypted, image-only, or exotic encodings)."""
    with open(path, "rb") as f:
        data = f.read()

    texts: List[str] = []
    for m in _STREAM_RE.finditer(data):
        dict_src = m.group(1)
        start = m.end()
        end = data.find(b"endstream", start)
        if end < 0:
            continue
        stream = data[start:end].rstrip(b"\r\n")
        if b"/FlateDecode" in dict_src:
            try:
                stream = zlib.decompress(stream)
            except zlib.error:
                continue
        elif b"/Filter" in dict_src:
            continue  # unsupported filter (DCT/JPX images, LZW, ...)
        # only bother with streams that contain text operators
        if b"BT" not in stream and b"Tj" not in stream and b"TJ" not in stream:
            continue
        extracted = _extract_from_content(stream)
        if extracted.strip():
            texts.append(extracted)
    return "\n".join(texts).strip()
