"""Streaming top-c select of the flat engine's stage 1 (kernel
`csrc/flat_topk.cu`).

Contract: for dots [rows, N] float32, bias [N] float32 and a scale,

    flat_topk(dots, bias, scale, c)
        == topk_stable(scale * dots + bias[None, :], c)[1]

on the card, exactly: each row's c largest scores in descending order,
equal scores to the lower column, the product and the sum rounded one at
a time as PyTorch's two elementwise passes round them. The score matrix
is never written: the kernel applies the scale and the bias as it reads
the dots once (`ops/distance.py:_two_stage` hands it cuBLAS's float32
stage-1 dots).

On the card every c takes the kernel: where its buffers fit in shared
memory beside the ring of dots (c up to 6,378 on the H100) they live
there, above that in a global scratch (`launch_plan`'s `resident`). CPU
tensors take the PyTorch path, `torch.topk(scale * dots + bias[None, :],
c)`: the flat engine's select as it was before the kernel (its tie order
is `torch.topk`'s). `flat_topk.paths` counts the calls of each path;
`flat_topk.launches` counts only the calls that launched the kernel.

While tracing is on (`utils.trace.tracing`), each kernel call adds the
keys its threshold filter admitted (a device-side int64 total, no sync)
to `flat_topk.admitted` and its rows to `flat_topk.traced_rows`: the
admission rate, `admitted / (traced_rows * N)`, shows whether the
running threshold works (0.44% of the keys at the flat benchmark cell's
chunk, PERF.md; most keys of a row sorted ascending).

`launch_plan` (plain Python, held on the CPU by the tests) cuts rows into
slabs so that the CTAs fill the card in nearly whole waves at any row
count: 256 rows of a query chunk and a serving flush of one row alike.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from leann_tpu_torch.ops import _cuda
from leann_tpu_torch.utils.trace import tracing

MAX_C = 1 << 29      # `kMaxC`: the largest c the kernel takes
TILE = 4096          # `kTile`: columns a CTA filters per round
STAGES = 3           # `kStages`: tiles of dots in a CTA's ring
CTAS_PER_SM = 3      # the most select CTAs an SM holds at once
FULL_WAVE = 0.85     # the share of the last wave of CTAs that must be busy
H100_SMEM_BLOCK = 232_272        # dynamic shared memory a CTA may take: 227
                                 # KB less the kernels' 176 B of static state
H100_SMEM_SM = 233_472           # an SM's shared memory (228 KB)
CTA_RESERVED = 1024 + 256        # an SM's shared memory a CTA takes besides
                                 # its dynamic share: the card's 1 KB and
                                 # the kernel's static state


def _pow2(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


@functools.lru_cache(maxsize=1024)
def launch_plan(rows: int, n: int, c: int, sms: int,
                smem_block: int = H100_SMEM_BLOCK,
                smem_sm: int = H100_SMEM_SM) -> dict:
    """How `flat_topk` launches for [rows, n] dots and a top-c on a card
    of `sms` SMs whose CTAs may take `smem_block` bytes of dynamic shared
    memory and whose SMs have `smem_sm`. A CTA takes one row over one
    slab of `slab_cols` columns (whole tiles). A row's buffer holds `cap`
    keys: at least 1024 and twice the power of two >= c (the final sort's
    width); beside it the compaction keeps c keys. These buffers live in
    shared memory beside the ring where they fit (`resident`), else in a
    global scratch of `scratch` keys a CTA. The SM then holds
    `ctas_per_sm` CTAs (at most CTAS_PER_SM). Each slab has at least
    8 * c columns, so that the running threshold has keys to filter;
    within that, the slabs are the fewest whose CTAs fill the card's
    `ctas_per_sm * sms` slots in waves that are each at least `FULL_WAVE`
    busy (a slab costs its CTA a final selection, and a wave left mostly
    idle costs the card), else as many as allowed. With more than one
    slab the merge kernel reduces the `slabs * c` keys of a row, kept in
    a scratch of `ldk` keys a row."""
    cap = max(1024, 2 * _pow2(c))
    buffers = cap + (c + 1) // 2 * 2
    # the select CTA's dynamic shared memory: the ring of STAGES tiles of
    # dots, the buffers where resident, the histogram
    smem = STAGES * TILE * 4 + 256 * 4
    resident = smem + buffers * 8 <= smem_block
    if resident:
        smem += buffers * 8
    ctas = max(1, min(CTAS_PER_SM, smem_sm // (smem + CTA_RESERVED)))
    tiles = -(-n // TILE)
    most = max(1, min(tiles // -(-8 * c // TILE), 65535))
    slots = ctas * sms
    slabs = most
    for s in range(1, most + 1):
        waves = max(1, rows) * s / slots
        if waves >= FULL_WAVE and waves / math.ceil(waves) >= FULL_WAVE:
            slabs = s
            break
    slab_tiles = -(-tiles // slabs)
    slabs = -(-tiles // slab_tiles)
    return {"slabs": slabs, "slab_cols": slab_tiles * TILE, "cap": cap,
            "grid": (rows, slabs),
            "ldk": (slabs * c + 1) // 2 * 2 if slabs > 1 else 0,
            "resident": resident, "scratch": 0 if resident else buffers,
            "ctas_per_sm": ctas, "smem_bytes": smem}


@functools.lru_cache(maxsize=None)
def _card(index: int) -> tuple:
    """(SMs, dynamic shared memory a CTA may take, an SM's shared memory)
    of card `index`."""
    lib = _cuda.load("flat_topk")
    block, sm = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        err = lib.leann_flat_topk_smem(ctypes.byref(block), ctypes.byref(sm))
    _cuda.check(lib, err, "flat_topk")
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, block.value, sm.value


def _check(dots, bias, c, out):
    if dots.dim() != 2 or bias.dim() != 1:
        raise ValueError("dots [rows, N] and bias [N] expected")
    if bias.shape[0] != dots.shape[1]:
        raise ValueError(f"bias has N={bias.shape[0]}, dots "
                         f"N={dots.shape[1]}")
    if dots.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"dots and bias must be float32, got {dots.dtype} "
                        f"and {bias.dtype}")
    if not (dots.is_contiguous() and bias.is_contiguous()):
        raise ValueError("dots and bias must be contiguous")
    if dots.device != bias.device:
        raise ValueError("dots and bias must be on one device")
    if dots.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dots.device}")
    if not 1 <= c <= min(dots.shape[1], MAX_C):
        raise ValueError(f"c={c} outside [1, N={dots.shape[1]}]"
                         + (f" or above {MAX_C}" if c > MAX_C else ""))
    if out is not None:
        if out.shape != (dots.shape[0], c) or out.dtype != torch.int64:
            raise ValueError(f"out must be int64 [{dots.shape[0]}, {c}]")
        if not out.is_contiguous() or out.device != dots.device:
            raise ValueError("out must be contiguous, on the dots' device")


def flat_topk(dots: torch.Tensor, bias: torch.Tensor, scale: float, c: int,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 [rows, c]: each row's top-c columns of scale * dots + bias
    (see the module docstring), written into `out` when given. CUDA
    tensors launch the kernel (N a multiple of 4, dots and bias 16-byte
    aligned, else ValueError); CPU tensors take the PyTorch path."""
    _check(dots, bias, c, out)
    rows, n = dots.shape
    if out is None:
        out = torch.empty((rows, c), dtype=torch.int64, device=dots.device)
    if dots.device.type == "cpu":
        out.copy_(torch.topk(scale * dots + bias[None, :], c, dim=1).indices)
        _cuda.count_path(flat_topk, "torch")
        return out
    if n % 4 or dots.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte chunks: N must be a "
                         "multiple of 4 and dots and bias 16-byte aligned")
    if rows == 0:
        return out
    dev = dots.device
    plan = launch_plan(rows, n, c, *_card(dev.index or 0))
    keys = torch.empty((rows, plan["ldk"]) if plan["slabs"] > 1 else (1, 2),
                       dtype=torch.int64, device=dev)
    scratch = None if plan["resident"] else torch.empty(
        (rows * plan["slabs"], plan["scratch"]), dtype=torch.int64,
        device=dev)
    traced = tracing()
    admitted = torch.zeros((), dtype=torch.int64, device=dev) if traced \
        else None
    lib = _cuda.load("flat_topk")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.leann_flat_topk(
            dots.data_ptr(), bias.data_ptr(), float(scale), rows, n, c,
            plan["slabs"], plan["slab_cols"], plan["cap"], out.data_ptr(),
            keys.data_ptr(), plan["ldk"],
            None if scratch is None else scratch.data_ptr(), plan["scratch"],
            admitted.data_ptr() if traced else None, stream)
    _cuda.check(lib, err, "flat_topk")
    _cuda.count_launch(flat_topk, path="kernel",
                       **({"admitted": admitted, "traced_rows": rows}
                          if traced else {}))
    return out


flat_topk.launches = 0
flat_topk.paths = {"kernel": 0, "torch": 0}
flat_topk.admitted = 0
flat_topk.traced_rows = 0
