"""Device resolution: the counterpart of `leann_tpu`'s `pallas_available`
(`leann_tpu/ops/pallas_kernels.py:51-57`).

Every entry point of the port takes `device=`; None means `cuda`. A
caller that wants the CPU (the tests) says so. Asking for CUDA where
there is none raises: the port never carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> cuda; raises when CUDA is asked for and is missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def kernels_available(device: DeviceLike = None) -> bool:
    """True when the hand-written CUDA kernels serve this device (the
    role `pallas_available()` plays in the reference's engine choice)."""
    return resolve_device(device).type == "cuda"


def free_device_bytes(device: torch.device) -> int:
    """Free memory on a CUDA device (engine sizing; the reference's
    thresholds were written for a 16 GB TPU v5e)."""
    free, _total = torch.cuda.mem_get_info(device)
    return int(free)
