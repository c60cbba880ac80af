"""Build and load the port's CUDA kernel library.

`csrc/fused_beam.cu` exposes a plain C interface. On first use it is
compiled by nvcc for Hopper into `leann_tpu_torch/_build/` (listed in
.gitignore) and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/fused_beam-<hash>.so csrc/fused_beam.cu

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
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def load(name: str = "fused_beam") -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, compiled on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, name + ".cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        out = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            res = subprocess.run(
                [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                 "-o", tmp, src],
                capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu:\n{res.stdout}{res.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.leann_fused_beam_search.argtypes = [ptr] * 9 + [i32] * 12 + [ptr]
        lib.leann_fused_beam_search.restype = i32
        lib.leann_fused_beam_smem_bytes.argtypes = [i32] * 5
        lib.leann_fused_beam_smem_bytes.restype = ctypes.c_size_t
        lib.leann_cuda_error_string.argtypes = [i32]
        lib.leann_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        msg = lib.leann_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
