"""Exact top-C select of IVF stage 1 (kernel `csrc/ivf_topc.cu`).

Contract: for kernel B4's dots [P, B, cap] float32 (`ivf_bucket_dots`),
the probes [B, P] int32 they were scored for, bucket_sq [K', cap] float32
and bucket_ids [K', cap] int32,

    ivf_topc(dots, probe, bucket_sq, bucket_ids, c, metric, sentinel)
        == ivf_topc_plain(dots, probe, bucket_sq, bucket_ids, c, metric,
                          sentinel)

on the card, bit for bit: (scores [B, c] float32, ids [B, c] int64), each
query's c largest of `2 * dot - bucket_sq` (l2) or `dot` (ip), -inf
where the slot's id is the sentinel, in `topk_stable`'s order over the
flattened position p * cap + slot (equal scores to the lower position);
a score of -inf, and the tail past a query's P * cap positions, has id
-1. That is also what `ops/ivf.py:ivf_search`'s running merge over the
probes returns for the same dots (its first fill of (-inf, -1) ranks
before every later -inf), which the CPU tests hold. The kernel reads the
dots once and writes only the survivors; `ivf_search` runs it under the
span `ivf.merge` after B4, on CUDA tensors.

CPU tensors take the plain version. `ivf_topc.launches` counts the
kernel's launches. Probes must lie in [0, K'): the kernel scores a probe
outside it as empty slots, the plain version raises or wraps as PyTorch's
indexing does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from leann_tpu_torch.ops import _cuda
from leann_tpu_torch.ops.distance import NEG_INF, topk_stable

MAX_C = 1 << 29      # `kMaxC`: the largest c the kernel takes
HIST_BYTES = 256 * 4  # the select's histogram, in dynamic shared memory


def _pow2(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def buffers(c: int) -> Tuple[int, int]:
    """(capb, keys a CTA keeps) for a top-c: a buffer of capb keys, at
    least 1024 and twice the power of two >= c (the final sort's width),
    and beside it the compaction's keep area of c keys (even)."""
    capb = max(1024, 2 * _pow2(c))
    return capb, capb + (c + 1) // 2 * 2


def resident(c: int, smem_block: int) -> bool:
    """Whether a CTA's buffers fit in the `smem_block` bytes of dynamic
    shared memory a CTA may take (c up to 8,192 on the H100)."""
    return buffers(c)[1] * 8 + HIST_BYTES <= smem_block


@functools.lru_cache(maxsize=None)
def _smem_block(index: int) -> int:
    """The dynamic shared memory a CTA of the kernel may take on card
    `index`."""
    lib = _cuda.load("ivf_topc")
    block = ctypes.c_int()
    with torch.cuda.device(index):
        err = lib.leann_ivf_topc_smem(ctypes.byref(block))
    _cuda.check(lib, err, "ivf_topc")
    return block.value


def _check(dots, probe, bucket_sq, bucket_ids, c, metric):
    if dots.dim() != 3 or probe.dim() != 2 or bucket_ids.dim() != 2:
        raise ValueError("dots [P, B, cap], probe [B, P] and bucket_ids "
                         "[K', cap] expected")
    p, b, cap = dots.shape
    if probe.shape != (b, p):
        raise ValueError(f"probe must be [{b}, {p}], got {tuple(probe.shape)}")
    if bucket_ids.shape[1] != cap or bucket_sq.shape != bucket_ids.shape:
        raise ValueError("bucket_sq and bucket_ids must be [K', cap] with "
                         f"cap={cap}")
    for t, dt in ((dots, torch.float32), (probe, torch.int32),
                  (bucket_sq, torch.float32), (bucket_ids, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"expected {dt}, got {t.dtype}")
        if t.device != dots.device:
            raise ValueError("all inputs must be on one device")
    if dots.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dots.device}")
    if metric not in ("l2", "ip"):
        raise ValueError(f"metric must be l2 or ip (got {metric!r})")
    if not 1 <= c <= MAX_C:
        raise ValueError(f"c={c} outside [1, {MAX_C}]")
    if p * cap >= 1 << 31:
        raise ValueError("P * cap must stay below 2^31")


def ivf_topc_plain(dots, probe, bucket_sq, bucket_ids, c: int, metric: str,
                   sentinel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `ivf_topc`: the l2 fold and the sentinel
    mask over [B, P, cap], then `topk_stable` over the flattened
    positions, -1 for every -inf, the tail filled with (-inf, -1)."""
    p, b, cap = dots.shape
    bucket = probe.long()
    ids = bucket_ids[bucket].long().reshape(b, p * cap)
    scores = dots.transpose(0, 1)
    if metric == "l2":
        scores = 2.0 * scores - bucket_sq[bucket]
    scores = torch.where(ids == sentinel, NEG_INF,
                         scores.reshape(b, p * cap))
    top, pos = topk_stable(scores, min(c, p * cap))
    top_ids = torch.where(top == NEG_INF, -1, torch.gather(ids, 1, pos))
    out_s = torch.full((b, c), NEG_INF, dtype=torch.float32,
                       device=dots.device)
    out_i = torch.full((b, c), -1, dtype=torch.int64, device=dots.device)
    out_s[:, : top.shape[1]] = top
    out_i[:, : top.shape[1]] = top_ids
    return out_s, out_i


def ivf_topc(dots: torch.Tensor, probe: torch.Tensor,
             bucket_sq: torch.Tensor, bucket_ids: torch.Tensor, c: int,
             metric: str, sentinel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, c] float32, ids [B, c] int64): each query's top-c of
    B4's dots with the l2 fold and the sentinel mask (see the module
    docstring). CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    _check(dots, probe, bucket_sq, bucket_ids, c, metric)
    if dots.device.type == "cpu":
        return ivf_topc_plain(dots, probe, bucket_sq, bucket_ids, c, metric,
                              sentinel)
    p, b, cap = dots.shape
    dev = dots.device
    capb, ld = buffers(c)
    in_smem = resident(c, _smem_block(dev.index or 0))
    d, pr, sq, ids = (t.contiguous() for t in (dots, probe, bucket_sq,
                                                bucket_ids))
    out_s = torch.empty((b, c), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, c), dtype=torch.int64, device=dev)
    scratch = None if in_smem else torch.empty((b, ld), dtype=torch.int64,
                                               device=dev)
    lib = _cuda.load("ivf_topc")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.leann_ivf_topc(
            d.data_ptr(), pr.data_ptr(), sq.data_ptr(), ids.data_ptr(), b, p,
            cap, ids.shape[0], c, capb, int(sentinel), int(metric == "l2"),
            out_s.data_ptr(), out_i.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else ld, stream)
    _cuda.check(lib, err, "ivf_topc")
    _cuda.count_launch(ivf_topc)
    return out_s, out_i


ivf_topc.launches = 0
