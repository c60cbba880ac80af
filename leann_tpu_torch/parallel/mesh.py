"""Device meshes for sharded search (port of `leann_tpu/parallel/mesh.py`).

The reference lays a `jax.sharding.Mesh` over its devices and runs one
program on every shard with `shard_map`. The port keeps the layout and
not the mechanism: a `Mesh` is a (dp, shard) grid of `torch.device`s held
by one process. `parallel/sharded.py` runs each shard's body on its
device (launches are asynchronous, so shards on different cards run at
once) and merges the shards' top-k on the dp row's first device.

A device may appear more than once in a mesh: `[torch.device("cpu")] * 8`
is the counterpart of the reference's eight virtual CPU devices, and four
shards may share one card. (One process per shard joined by NCCL cannot
do that: NCCL refuses two ranks on one GPU.)

Across processes (`init_distributed`), each process holds a mesh of its
own devices and serves the shards [rank * s, (rank + 1) * s), s being its
local shard count; `shape["shard"]` counts the shards of every process,
and one all_gather merges the processes' top-k.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from leann_tpu_torch.device import resolve_device


def _process_group() -> Tuple[int, int]:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _canonical(device) -> torch.device:
    """A resolved device with its index filled in, so that "cuda" and
    "cuda:0" count as one device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A grid of devices with named axes ("dp", "shard"), held by one
    process of `process_count`. `shape` maps each axis name to its size;
    the shard axis counts the shards of all processes."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_index: int = 0, process_count: int = 1):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_index = process_index
        self.process_count = process_count
        grid = devices
        if "dp" in self.axis_names and "shard" in self.axis_names:
            grid = np.moveaxis(devices, [self.axis_names.index("dp"),
                                         self.axis_names.index("shard")],
                               [0, 1])
        elif "shard" in self.axis_names:
            grid = devices.reshape(1, -1)
        # [dp, local shards]: the devices of this process
        self.grid = grid.reshape(grid.shape[0], -1)
        self.local_shards = self.grid.shape[1]
        self.shard_offset = process_index * self.local_shards

    @property
    def shape(self) -> dict:
        out = dict(zip(self.axis_names, self.devices.shape))
        if "shard" in out:
            out["shard"] *= self.process_count
        return out

    def is_local(self, shard: int) -> bool:
        return 0 <= shard - self.shard_offset < self.local_shards

    def shard_devices(self, shard: int) -> List[torch.device]:
        """The distinct devices that hold a local shard (one per dp row,
        repeats dropped, in row order)."""
        out: List[torch.device] = []
        for dev in self.grid[:, shard - self.shard_offset]:
            if dev not in out:
                out.append(dev)
        return out

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """`t` from every process in rank order (a list of one tensor in
        a single process), on t's device. gloo gathers on the host."""
        if self.process_count == 1:
            return [t]
        import torch.distributed as dist

        comm = t.contiguous()
        if dist.get_backend() != "nccl":
            comm = comm.cpu()
        out = [torch.empty_like(comm) for _ in range(self.process_count)]
        dist.all_gather(out, comm)
        return [o.to(t.device) for o in out]

    def gather_objects(self, local: list) -> list:
        """The concatenation of every process's `local` list, in rank
        order (host objects, e.g. per-shard arrays to save)."""
        if self.process_count == 1:
            return list(local)
        import torch.distributed as dist

        out = [None] * self.process_count
        dist.all_gather_object(out, list(local))
        return [x for part in out for x in part]

    def max_over_processes(self, values: Sequence[int]) -> List[int]:
        """Elementwise maximum of integer `values` over the processes."""
        if self.process_count == 1:
            return [int(v) for v in values]
        parts = self.all_gather(torch.tensor(list(values), dtype=torch.int64,
                                             device=self.grid[0, 0]))
        return torch.stack(parts).amax(0).tolist()


def _default_devices() -> List[torch.device]:
    """Every CUDA device of this process; under a process group of more
    than one process, the one card of this rank (`LOCAL_RANK`, else the
    rank, modulo the cards present). Raises without CUDA."""
    resolve_device(None)
    rank, world = _process_group()
    count = torch.cuda.device_count()
    if world > 1:
        return [torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", rank)) % count)]
    return [torch.device("cuda", i) for i in range(count)]


def make_mesh(
    axis_sizes: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("dp", "shard"),
    devices=None,
) -> Mesh:
    """Mesh over this process's devices. Default: every device on
    `shard` (corpus parallel), dp=1; pass axis_sizes to split, e.g.
    (2, 4). `devices=None` means every CUDA device (raises without one);
    a device may be listed more than once."""
    devices = [_canonical(d) for d in (
        devices if devices is not None else _default_devices())]
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = (1, n)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"axis sizes {axis_sizes} != device count {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    arr = arr.reshape(axis_sizes)
    rank, world = _process_group()
    return Mesh(arr, tuple(axis_names)[: arr.ndim], rank, world)


def init_distributed(backend: Optional[str] = None) -> bool:
    """Multi-process bring-up: call once per process before building a
    mesh. Reads torch's environment contract (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK; LOCAL_RANK picks the card) and initializes the
    default process group, `nccl` where CUDA is present and `gloo`
    otherwise (or `backend`). A no-op returning False when WORLD_SIZE is
    unset or 1: one process needs no group.

    Returns True when a process group of more than one process was (or
    already is) initialized. Each process then builds and searches its
    own shards; only the final [B, k] merge crosses processes."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE") or 1)
    if world <= 1:
        return False
    rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://",
                            world_size=world, rank=rank)
    return True
