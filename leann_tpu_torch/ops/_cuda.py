"""Build and load the port's CUDA kernel libraries.

Each `csrc/<name>.cu` exposes a plain C interface. On first use it is
compiled by nvcc for Hopper into `leann_tpu_torch/_build/` (listed in
.gitignore) and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and of the headers in
csrc/, so an edited kernel is rebuilt and a stale one is never loaded. Nothing here runs at import
time: the CPU tests import every module on a machine without nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, List, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()
_DEFERRED = threading.local()

_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# (argtypes, restype) of each library's exported functions; every library
# also exports leann_cuda_error_string
SIGNATURES = {
    "fused_beam": {
        "leann_fused_beam_search": ([_PTR] * 12 + [_I32] * 13 + [_PTR], _I32),
        "leann_fused_beam_smem_bytes": ([_I32] * 6, ctypes.c_size_t),
        "leann_fused_beam_ctas_per_sm": ([_I32] * 6, _I32),
    },
    "pq_beam": {
        "leann_pq_beam_search": ([_PTR] * 10 + [_I32] * 15 + [_PTR], _I32),
        "leann_pq_beam_smem_bytes": ([_I32] * 7, ctypes.c_size_t),
        "leann_pq_beam_ctas_per_sm": ([_I32] * 7, _I32),
    },
    "ivf_bucket_dots": {
        "leann_ivf_bucket_dots": ([_PTR] * 7 + [_I32] * 8 + [_PTR], _I32),
        "leann_ivf_bucket_dots_ctas_per_sm": ([_I32], _I32),
        "leann_bucket_items": ([_PTR] + [_I32] * 4 + [_PTR] * 3, _I32),
    },
    "ivf8_scan": {
        "leann_ivf8_bucket_scores": ([_PTR] * 11 + [_I32] * 9 + [_PTR], _I32),
        "leann_ivf8_bucket_scores_ctas_per_sm": ([_I32], _I32),
        "leann_bucket_items": ([_PTR] + [_I32] * 4 + [_PTR] * 3, _I32),
    },
    "gather_score": {
        "leann_gather_score": (
            [_PTR] * 4 + [ctypes.c_longlong] + [_I32] * 8 + [_PTR], _I32),
        "leann_gather_score_rowwise": (
            [_PTR] * 4 + [ctypes.c_longlong] + [_I32] * 5 + [_PTR], _I32),
    },
    "flat_topk": {
        "leann_flat_topk": ([_PTR] * 2 + [ctypes.c_float] + [_I32] * 6
                            + [_PTR] * 2 + [_I32] + [_PTR]
                            + [ctypes.c_longlong] + [_PTR] * 2, _I32),
        "leann_flat_topk_smem": ([_PTR] * 2, _I32),
    },
    "ivf_topc": {
        "leann_ivf_topc": ([_PTR] * 4 + [_I32] * 8 + [_PTR] * 3
                           + [ctypes.c_longlong] + [_PTR], _I32),
        "leann_ivf_topc_smem": ([_PTR], _I32),
    },
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _so_path(name: str) -> str:
    """The library's path, named by a hash of its source and of every
    header in csrc/ (a source may include them)."""
    h = hashlib.sha256()
    for fn in [name + ".cu"] + sorted(
            f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")):
        with open(os.path.join(CSRC_DIR, fn), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def build(names: Sequence[str]) -> None:
    """Compile the libraries of `names` that are not built yet, one nvcc
    per source, all started together."""
    jobs = []
    for name in names:
        out = _so_path(name)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, compiled on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        build([name])
        lib = ctypes.CDLL(_so_path(name))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib.leann_cuda_error_string.argtypes = [_I32]
        lib.leann_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
        return lib


def count_launch(wrapper, path: str = None, **totals) -> None:
    """Add one to `wrapper.launches` (and to `wrapper.paths[path]`, for a
    wrapper that chooses between two kernels) under a lock: the HTTP
    server's flush pool launches kernels from two threads at once.
    `totals` are added as `count_work` adds them."""
    if _deferred(count_launch, wrapper, path, **totals):
        return
    with _COUNT_LOCK:
        wrapper.launches += 1
        if path is not None:
            wrapper.paths[path] += 1
        _add(wrapper, totals)


@contextlib.contextmanager
def deferred_counts():
    """Keep what `count_launch`, `count_path` and `count_work` count in
    this thread's block aside, in the list it yields, instead of adding
    it: work captured into a CUDA graph runs only when the graph replays,
    and each replay adds the list (`add_counts`)."""
    _DEFERRED.counts = counts = []
    try:
        yield counts
    finally:
        _DEFERRED.counts = None


def _deferred(count, *args, **kw) -> bool:
    """Whether a `deferred_counts` block of this thread kept the count."""
    counts = getattr(_DEFERRED, "counts", None)
    if counts is None:
        return False
    counts.append(functools.partial(count, *args, **kw))
    return True


def add_counts(counts: List[Callable[[], None]]) -> None:
    """Count what a `deferred_counts` block kept aside."""
    for count in counts:
        count()


def count_path(wrapper, path: str) -> None:
    """Add one to `wrapper.paths[path]` alone, under the launch counter's
    lock: a call that took a path with no kernel, which `launches` leaves
    out."""
    if _deferred(count_path, wrapper, path):
        return
    with _COUNT_LOCK:
        wrapper.paths[path] += 1


def count_work(wrapper, **totals) -> None:
    """Add each of `totals` (an int, or a one-element device tensor) to
    the wrapper's attribute of that name, under the launch counter's
    lock. A tensor is added on the device, with no sync: the total
    becomes a tensor on the device of its first tensor amount, read
    (`int(...)`) only by whoever reads it."""
    if _deferred(count_work, wrapper, **totals):
        return
    with _COUNT_LOCK:
        _add(wrapper, totals)


def _add(wrapper, totals) -> None:
    for name, amount in totals.items():
        total = getattr(wrapper, name)
        device = getattr(total, "device", None)
        if device is not None and getattr(amount, "device", device) != device:
            amount = amount.to(device, non_blocking=True)
        setattr(wrapper, name, total + amount)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        msg = lib.leann_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
