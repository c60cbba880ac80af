"""usearch `.index` binary import — migrate a leann-rs index without
re-embedding, even when `.embeddings` was pruned.

The reference saves its HNSW through the usearch crate
(leann-rs's `src/backend/hnsw.rs:133-135`, usearch 2.23.0 per its
Cargo.lock) and, crucially, usearch's default serialization *includes
the raw vectors* in the file. So a reference `.index` holds everything
needed to migrate: the f32 embedding matrix, the keys, and the HNSW
adjacency (whose level-0 layer is a usable fixed-degree graph).

File layout (usearch 2.x `index_dense_gt::save_to_stream` +
`index_gt::save_to_stream`; all integers little-endian, structs packed):

    [vectors]   only when saved without `exclude_vectors` (the crate's
                default):
                  u32 rows, u32 bytes_per_vector      (8 bytes)
                  rows x bytes_per_vector raw scalars (slot order)
    [head]      64-byte buffer:
                  0..7   magic  b"usearch"
                  7..10  version major, minor, patch  (u8 each)
                  10     kind_metric   (metric_kind_t, u8)
                  11     kind_scalar   (scalar_kind_t, u8)
                  12     kind_key      (scalar_kind_t, u8)
                  13     kind_compressed_slot (scalar_kind_t, u8)
                  14..22 count_present  u64
                  22..30 count_deleted  u64
                  30..38 dimensions     u64
                  38     multi          u8 (bool)
                  rest   zero padding
    [graph]     index_serialized_header_t: 5 x u64
                  size, connectivity, connectivity_base,
                  max_level, entry_slot                (40 bytes)
                size x i16 per-node levels
                size node tapes, each:
                  u64 key, i16 level,
                  level-0 block: u32 count + connectivity_base u32 slots,
                  then `level` upper blocks:
                              u32 count + connectivity   u32 slots

Every parse is validated end-to-end: the computed node strides must
land exactly on EOF, the per-tape levels must equal the level array,
and counts must fit their blocks. Any inconsistency raises
:class:`UsearchParseError` and callers fall back to the reference's own
posture for foreign indexes (tell the user to rebuild —
`src/backend/compat.rs:15-38`).

This parser is written against the usearch 2.x on-disk format as
implemented in `index_dense.hpp` / `index.hpp`; it intentionally
supports only the shape the reference produces (f32 scalars, u64 keys,
u32 slots, multi=false) and rejects anything else loudly rather than
guessing.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

MAGIC = b"usearch"
_HEAD_BYTES = 64
_GRAPH_HEADER_BYTES = 40
_KEY_BYTES = 8          # u64 keys (reference adds ids 0..n as u64)
_LEVEL_BYTES = 2        # level_t = i16
_COUNT_BYTES = 4        # neighbors_count_t = u32
_SLOT_BYTES = 4         # compressed_slot_t = u32


class UsearchParseError(ValueError):
    """The file is not a (supported) usearch v2 dense index."""


@dataclass
class UsearchIndexData:
    """Everything recovered from a usearch `.index` file, in slot order."""

    vectors: Optional[np.ndarray]   # [n, d] f32 or None (exclude_vectors)
    keys: np.ndarray                # [n] u64
    adjacency: np.ndarray           # [n, connectivity_base] int32, KEY space,
                                    # padded with n (GraphFile convention)
    levels: np.ndarray              # [n] i16
    connectivity: int
    connectivity_base: int
    entry_key: int
    dimensions: int
    version: tuple                  # (major, minor, patch)

    @property
    def n(self) -> int:
        return int(self.keys.shape[0])


def looks_like_usearch(path: str) -> bool:
    """Cheap sniff: magic at offset 0 (exclude_vectors) or at the end of
    a plausible u32 vector-matrix section."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(8)
            if head[:7] == MAGIC:
                return True
            if len(head) < 8:
                return False
            rows, bpv = struct.unpack("<II", head)
            off = 8 + rows * bpv
            if off + _HEAD_BYTES > size:
                return False
            f.seek(off)
            return f.read(7) == MAGIC
    except OSError:
        return False


def parse_usearch_index(path: str) -> UsearchIndexData:
    """Parse a usearch v2 dense `.index` file. Raises UsearchParseError
    on any structural inconsistency (strict whole-file accounting)."""
    file_size = os.path.getsize(path)
    buf = np.memmap(path, dtype=np.uint8, mode="r")

    def _fail(msg: str) -> "UsearchParseError":
        return UsearchParseError(f"{path}: {msg}")

    # --- locate the head: vectors-first (default) or head-first -------
    vectors = None
    if bytes(buf[:7]) == MAGIC:
        head_off = 0
    else:
        if file_size < 8 + _HEAD_BYTES:
            raise _fail("too small for a usearch index")
        rows, bpv = struct.unpack("<II", bytes(buf[:8]))
        head_off = 8 + rows * bpv
        if head_off + _HEAD_BYTES > file_size or \
                bytes(buf[head_off:head_off + 7]) != MAGIC:
            raise _fail("no usearch magic at offset 0 or after the "
                        "vector matrix")
        if bpv % 4 != 0:
            raise _fail(f"bytes_per_vector {bpv} is not f32-shaped")
        vectors = np.asarray(
            buf[8:head_off].view(np.float32).reshape(rows, bpv // 4)
        ) if rows else np.zeros((0, 0), np.float32)

    # --- 64-byte dense head -------------------------------------------
    head = bytes(buf[head_off:head_off + _HEAD_BYTES])
    ver = (head[7], head[8], head[9])
    if ver[0] != 2:
        raise _fail(f"unsupported usearch major version {ver[0]}")
    count_present, count_deleted, dimensions = struct.unpack(
        "<QQQ", head[14:38])
    multi = head[38]
    if multi:
        raise _fail("multi-key indexes are not supported")
    if vectors is not None and vectors.size:
        if vectors.shape[1] != dimensions:
            raise _fail(
                f"vector matrix is {vectors.shape[1]}-d but head says "
                f"{dimensions}-d (non-f32 scalar kind?)")

    # --- graph header ---------------------------------------------------
    g = head_off + _HEAD_BYTES
    if g + _GRAPH_HEADER_BYTES > file_size:
        raise _fail("truncated graph header")
    size, conn, conn_base, max_level, entry_slot = struct.unpack(
        "<QQQQQ", bytes(buf[g:g + _GRAPH_HEADER_BYTES]))
    if size != count_present + count_deleted:
        raise _fail(f"graph size {size} != head counts "
                    f"{count_present}+{count_deleted}")
    if vectors is not None and vectors.shape[0] not in (0, size):
        raise _fail(f"vector rows {vectors.shape[0]} != graph size {size}")
    if size == 0:
        raise _fail("empty index")
    if not (0 < conn <= conn_base <= 4096):
        raise _fail(f"implausible connectivity {conn}/{conn_base}")
    if entry_slot >= size:
        raise _fail(f"entry slot {entry_slot} out of range")

    # --- levels + node strides (vectorized whole-file accounting) -----
    lv_off = g + _GRAPH_HEADER_BYTES
    nodes_off = lv_off + size * _LEVEL_BYTES
    if nodes_off > file_size:
        raise _fail("truncated level array")
    levels = np.asarray(
        buf[lv_off:nodes_off].view(np.int16), dtype=np.int64)
    if levels.min() < 0 or levels.max() != max_level:
        raise _fail(
            f"level array [{levels.min()}, {levels.max()}] inconsistent "
            f"with max_level {max_level}")

    base_block = _COUNT_BYTES + conn_base * _SLOT_BYTES
    upper_block = _COUNT_BYTES + conn * _SLOT_BYTES
    node_bytes = (_KEY_BYTES + _LEVEL_BYTES + base_block
                  + levels * upper_block)
    offsets = nodes_off + np.concatenate(
        ([0], np.cumsum(node_bytes)[:-1]))
    end = nodes_off + int(node_bytes.sum())
    if end != file_size:
        raise _fail(
            f"node tapes end at {end} but file is {file_size} bytes "
            "(unsupported key/slot width or corrupt file)")

    # --- gather keys, tape levels, and level-0 adjacency in chunks ----
    n = int(size)
    keys = np.empty(n, np.uint64)
    tape_levels = np.empty(n, np.int16)
    adjacency = np.empty((n, conn_base), np.int64)
    counts = np.empty(n, np.int64)
    flat = buf  # uint8 view of the whole file
    l0 = _KEY_BYTES + _LEVEL_BYTES          # level-0 block offset in tape
    key_ix = np.arange(_KEY_BYTES)
    cnt_ix = l0 + np.arange(_COUNT_BYTES)
    slot_ix = l0 + _COUNT_BYTES + np.arange(conn_base * _SLOT_BYTES)
    chunk = max(1, min(n, 1 << 16))
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        off = offsets[s:e, None]
        keys[s:e] = (
            flat[off + key_ix[None, :]].copy().view("<u8").ravel())
        tape_levels[s:e] = (
            flat[off + (key_ix[:2] + _KEY_BYTES)[None, :]]
            .copy().view("<i2").ravel())
        counts[s:e] = (
            flat[off + cnt_ix[None, :]].copy().view("<u4").ravel())
        adjacency[s:e] = (
            flat[off + slot_ix[None, :]].copy().view("<u4")
            .reshape(e - s, conn_base))
    if not np.array_equal(tape_levels.astype(np.int64), levels):
        raise _fail("per-tape levels disagree with the level array")
    if counts.max() > conn_base:
        raise _fail(f"level-0 neighbor count {counts.max()} exceeds "
                    f"capacity {conn_base}")
    if adjacency.max() >= n:
        raise _fail("neighbor slot out of range")

    # mask tail capacity beyond each node's count, remap slots -> keys,
    # pad with n (GraphFile convention: one past the last row)
    col = np.arange(conn_base)[None, :]
    valid = col < counts[:, None]
    key_i64 = keys.astype(np.int64)
    if key_i64.min() < 0:
        raise _fail("keys exceed int64 range")
    mapped = np.where(valid, key_i64[adjacency], n)
    if mapped.max() > np.iinfo(np.int32).max:
        raise _fail("keys exceed int32 range (too large for the "
                    "graph format)")

    return UsearchIndexData(
        vectors=vectors,
        keys=keys,
        adjacency=mapped.astype(np.int32),
        levels=tape_levels,
        connectivity=int(conn),
        connectivity_base=int(conn_base),
        entry_key=int(key_i64[entry_slot]),
        dimensions=int(dimensions),
        version=ver,
    )


def to_key_order(data: UsearchIndexData):
    """Reorder slot-ordered payloads into key order for indexes whose
    keys are a permutation of 0..n-1 (always true for reference-built
    indexes — `src/backend/hnsw.rs:126-128` adds ids sequentially).

    Returns (vectors_or_None [n,d] f32, adjacency [n,R] int32 in key
    space padded with n, medoid_key int). Raises UsearchParseError when
    keys are not a dense 0..n-1 permutation."""
    n = data.n
    key_i64 = data.keys.astype(np.int64)
    order = np.argsort(key_i64, kind="stable")
    if not np.array_equal(key_i64[order], np.arange(n)):
        raise UsearchParseError(
            "index keys are not a dense 0..n-1 permutation; cannot map "
            "onto row-ordered passages/ids")
    vectors = data.vectors[order] if data.vectors is not None else None
    adjacency = data.adjacency[order]
    return vectors, adjacency, data.entry_key
