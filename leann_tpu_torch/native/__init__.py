"""The native C++ host runtime (the port's copy of `leann_tpu/native/`).

Two host paths are hot at 1M-chunk scale and have a C++ implementation
in `csrc/leann_native.cpp`, bound with ctypes, beside a pure-Python one:

  - the BM25 tokenization and postings build (`index/bm25.py`'s
    `Bm25Scorer.build` calls `bm25_build_native` first);
  - the JSONL line-offset scan (`scan_line_offsets` in the C ABI).

On first use the source is compiled with g++ into
`leann_tpu_torch/_build/libleann_native-<hash>.so` (`<hash>`: the
source's sha256), beside the CUDA kernels' libraries; a stale or foreign
binary is never loaded. Nothing is compiled at import time. Absence is
never an error: without g++ or without the source, `bm25_build_native`
returns None and the caller builds in Python.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_LIB_CHECKED = False


def _load_lib():
    """The loaded and configured library, or None when it cannot be
    built; compiled on the first call in a process, loaded after."""
    global _LIB, _LIB_CHECKED
    with _LOCK:
        if _LIB_CHECKED:
            return _LIB
        _LIB_CHECKED = True
        import ctypes

        from leann_tpu_torch.native.bm25_bridge import configure

        path = _compiled_lib_path()
        if path is not None:
            try:
                _LIB = ctypes.CDLL(path)
                configure(_LIB)
            except (OSError, AttributeError) as e:
                _warn(f"cannot load {path}: {type(e).__name__}: {e}")
                _LIB = None
        return _LIB


def _compiled_lib_path() -> Optional[str]:
    """Compile `csrc/leann_native.cpp` into `_build/`, named by the
    source's hash, unless it is there already; None without g++ or the
    source, or when g++ fails. One process at a time compiles (a lock
    file in `_build/`); the compiler writes a per-process file that
    `os.replace` moves into place, so a concurrent reader (another test
    worker, a server thread) never loads a half-written library and a
    built one is never replaced."""
    import fcntl
    import hashlib
    import os
    import shutil
    import subprocess

    from leann_tpu_torch.ops._cuda import BUILD_DIR, CSRC_DIR

    src = os.path.join(CSRC_DIR, "leann_native.cpp")
    if not os.path.exists(src) or shutil.which("g++") is None:
        return None
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libleann_native-{digest}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, "libleann_native.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(out):
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                     "-o", tmp, src],
                    check=True, capture_output=True, text=True, timeout=120,
                )
                os.replace(tmp, out)
        return out
    except subprocess.CalledProcessError as e:
        _warn(f"g++ failed on {src}: {e.stderr[-2000:]}")
    except (OSError, subprocess.SubprocessError) as e:
        _warn(f"cannot build {src}: {type(e).__name__}: {e}")
    if os.path.exists(tmp):
        os.remove(tmp)
    return None


def _warn(msg: str) -> None:
    from leann_tpu_torch.utils.trace import logger

    logger.warning("native runtime unavailable (%s); BM25 builds in Python",
                   msg)


def bm25_build_native(
    documents: Sequence[str],
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Build BM25 postings in C++. Returns the Bm25Scorer constructor args
    (vocab, offsets, post_docs, post_tfs, doc_lengths) or None when the
    native library is unavailable."""
    lib = _load_lib()
    if lib is None:
        return None
    from leann_tpu_torch.native.bm25_bridge import build_postings

    return build_postings(lib, documents)
