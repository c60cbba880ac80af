"""ctypes bridge for the native BM25 builder (`csrc/leann_native.cpp`):
the port's copy of `leann_tpu/native/bm25_bridge.py`."""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np


def configure(lib) -> None:
    """Declare argtypes and restype of every function of the C ABI."""
    if getattr(lib, "_leann_configured", False):
        return
    lib.bm25_build.restype = ctypes.c_void_p
    lib.bm25_build.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    for fn in (lib.bm25_vocab_size, lib.bm25_total_postings, lib.bm25_vocab_bytes):
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.bm25_export.restype = None
    lib.bm25_export.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.bm25_free.restype = None
    lib.bm25_free.argtypes = [ctypes.c_void_p]
    lib.scan_line_offsets.restype = ctypes.c_int64
    lib.scan_line_offsets.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib._leann_configured = True


def build_postings(
    lib, documents: Sequence[str]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (vocab, offsets, post_docs, post_tfs, doc_lengths) — the
    Bm25Scorer constructor args."""
    configure(lib)
    n = len(documents)
    encoded = [d.encode("utf-8", "replace") for d in documents]
    buf = b"".join(encoded)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])

    handle = lib.bm25_build(
        buf, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
    )
    if not handle:
        raise RuntimeError("bm25_build returned null")
    try:
        v = lib.bm25_vocab_size(handle)
        p = lib.bm25_total_postings(handle)
        vb = lib.bm25_vocab_bytes(handle)

        vocab_buf = ctypes.create_string_buffer(max(int(vb), 1))
        vocab_offsets = np.zeros(v + 1, dtype=np.int64)
        post_offsets = np.zeros(v + 1, dtype=np.int64)
        post_docs = np.zeros(max(int(p), 1), dtype=np.int32)
        post_tfs = np.zeros(max(int(p), 1), dtype=np.int32)
        doc_lengths = np.zeros(max(n, 1), dtype=np.int32)

        lib.bm25_export(
            handle,
            vocab_buf,
            vocab_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            post_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            post_docs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            post_tfs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            doc_lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    finally:
        lib.bm25_free(handle)

    raw = vocab_buf.raw
    terms = [
        raw[vocab_offsets[i]:vocab_offsets[i + 1]].decode("utf-8")
        for i in range(v)
    ]
    vocab = np.asarray(terms, dtype=np.str_) if terms else np.zeros(0, np.str_)
    return (
        vocab,
        post_offsets,
        post_docs[:p],
        post_tfs[:p],
        doc_lengths[:n],
    )
