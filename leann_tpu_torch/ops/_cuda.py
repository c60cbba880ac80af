"""Build and load the port's CUDA kernel libraries.

Each `csrc/<name>.cu` exposes a plain C interface. On first use it is
compiled by nvcc for Hopper into `leann_tpu_torch/_build/` (listed in
.gitignore) and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, so an edited kernel is
rebuilt and a stale one is never loaded. Nothing here runs at import
time: the CPU tests import every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}

_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# (argtypes, restype) of each library's exported functions; every library
# also exports leann_cuda_error_string
SIGNATURES = {
    "fused_beam": {
        "leann_fused_beam_search": ([_PTR] * 10 + [_I32] * 13 + [_PTR], _I32),
        "leann_fused_beam_smem_bytes": ([_I32] * 5, ctypes.c_size_t),
    },
    "pq_beam": {
        "leann_pq_beam_search": ([_PTR] * 10 + [_I32] * 15 + [_PTR], _I32),
        "leann_pq_beam_smem_bytes": ([_I32] * 6, ctypes.c_size_t),
    },
    "ivf_bucket_dots": {
        "leann_ivf_bucket_dots": ([_PTR] * 4 + [_I32] * 7 + [_PTR], _I32),
    },
    "ivf8_scan": {
        "leann_ivf8_bucket_scores": ([_PTR] * 8 + [_I32] * 8 + [_PTR], _I32),
    },
    "gather_score": {
        "leann_gather_score": (
            [_PTR] * 4 + [ctypes.c_longlong] + [_I32] * 5 + [_PTR], _I32),
    },
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _so_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
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


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        msg = lib.leann_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
