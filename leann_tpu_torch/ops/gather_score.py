"""Row-gather scoring against a device-resident int8 corpus (port of
`leann_tpu/ops/gather_score.py`): kernel B5.

Contract:  scores[b, j] = <bf16(queries[b]), corpus_i8[ids[b, j]]>

with the int8 value read as its integer, the query rounded to bf16, the
products and the sum in float32 (callers fold per-row dequantization
scales into the final ranking). It is the hot step of a pointer-gather
graph traversal (one corpus row per (query, neighbour)) and of an exact
rescore; `evals/gather_roofline.py` measures how many such rows per
second the device fetches, the ceiling of any traversal that shares one
corpus instead of inlining neighbour records.

`gather_score` launches the CUDA kernel (`csrc/gather_score.cu`) on CUDA
tensors and runs `gather_score_plain` on CPU tensors; there is no
fallback from one to the other. The reference pads D and the id lanes to
128 and needs B % qb == 0, D <= 128 and R <= 128 for its TPU tiling; the
port takes any B, R and D and pads nothing.

`launch_plan` (plain Python, held on the CPU by the tests) chooses the
kernel by shape and sizes its launch: rows with D % 16 == 0 in a 16-byte
aligned corpus go to the staged kernel (tiles of qpc queries x rps rows
staged in a two-stage shared-memory ring by a persistent grid), other
rows, or a D so large that two stages of one row and its query pass the
card's 227 KB, to the per-row kernel. `gather_score.paths` counts the
launches of each.

Sums: int8 x bf16 products are exact in float32. The plain version adds
them in a matrix product's order, the kernel in lane-group order, so the
two agree to float32 rounding of the sums, about 1e-7 x |q| x |row|
(`chip_smoke.py` holds them to 1e-5 x that).
"""

from __future__ import annotations

import functools

import torch

from leann_tpu_torch.ops.bucket_kernels import _PLAIN_CHUNK, _lanes

STAGED_THREADS = 256        # `kThreads` of the staged kernel
CTAS_PER_SM = 4             # `kMinCtas`: the persistent grid per SM
STAGE_BYTES = 24 << 10      # rows + queries + ids of one stage
TILE_ROWS = 4 * STAGED_THREADS   # ids a tile holds in registers
SMEM_PER_CTA = 232_448      # the H100's opt-in limit of one block (227 KB)
SMEM_PER_SM = 233_472       # of one SM (228 KB), 1 KB of it per CTA


def _check(corpus_i8, ids, queries):
    if corpus_i8.dim() != 2 or ids.dim() != 2 or queries.dim() != 2:
        raise ValueError("corpus [N, D], ids [B, R] and queries [B, D] "
                         "expected")
    if queries.shape[1] != corpus_i8.shape[1]:
        raise ValueError(f"queries have D={queries.shape[1]}, the corpus "
                         f"D={corpus_i8.shape[1]}")
    if ids.shape[0] != queries.shape[0]:
        raise ValueError(f"ids have B={ids.shape[0]}, queries "
                         f"B={queries.shape[0]}")
    if corpus_i8.dtype != torch.int8:
        raise TypeError(f"corpus must be int8, got {corpus_i8.dtype}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    if not (corpus_i8.device == ids.device == queries.device):
        raise ValueError("all inputs must be on one device")
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {queries.device}")


def gather_score_plain(corpus_i8, ids, queries) -> torch.Tensor:
    """Plain PyTorch version of `gather_score` (the function of the
    reference's `gather_score_xla`): gathered rows widened to float32,
    times the bf16-rounded query, summed in float32."""
    b, r = ids.shape
    d = corpus_i8.shape[1]
    q = queries.float().to(torch.bfloat16).float()
    out = torch.empty((b, r), dtype=torch.float32, device=queries.device)
    qc = max(1, _PLAIN_CHUNK // max(1, r * d))
    for s in range(0, b, qc):
        rows = corpus_i8[ids[s : s + qc].long()].float()     # [qc, R, D]
        out[s : s + qc] = torch.einsum("brd,bd->br", rows, q[s : s + qc])
    return out


def _round16(x: int) -> int:
    return -(-x // 16) * 16


@functools.lru_cache(maxsize=1024)
def launch_plan(b: int, r: int, d: int, sms: int,
                aligned: bool = True) -> dict:
    """How `gather_score` launches for [B, R] ids into an [N, D] corpus
    on a card of `sms` SMs (`aligned`: the corpus is 16-byte aligned).

    Staged path (D % 16 == 0 and aligned): a stage holds qpc queries (f32,
    4*D bytes each) and rps rows of each (D bytes and a 4-byte id a row)
    in at most `STAGE_BYTES`, or in one row and its query where D is
    larger, and at most `TILE_ROWS` rows; two stages make the CTA's
    shared memory. A row list longer than a stage is cut into `chunks`
    equal runs of rps <= R rows. qpc grows until the tiles would no
    longer give each CTA of the grid (`CTAS_PER_SM` per SM, fewer where
    the stages do not fit that many times in an SM) two tiles, so that a
    CTA scores its first tile while the second lands. The grid is at most
    one CTA per tile. Rows of other shapes take the per-row path: one CTA
    of 128 threads per query, 4*D bytes of shared memory."""
    if d % 16 == 0 and aligned:
        qbytes, per_row = 4 * d, d + 4
        budget = max(STAGE_BYTES, qbytes + per_row)
        chunks = -(-r // min(TILE_ROWS, (budget - qbytes) // per_row))
        rps = -(-r // chunks)
        qpc_max = max(1, min(budget // (rps * per_row + qbytes),
                             TILE_ROWS // rps))
        slots = sms * CTAS_PER_SM
        qpc = max(1, min(qpc_max, b, -(-b * chunks // (2 * slots))))
        stage = qpc * (rps * d + qbytes) + _round16(qpc * rps * 4)
        smem = 2 * stage
        if smem <= SMEM_PER_CTA:
            ctas = max(1, min(CTAS_PER_SM, SMEM_PER_SM // (smem + 1024)))
            tiles = -(-b // qpc) * chunks
            return {"path": "staged", "qpc": qpc, "rps": rps,
                    "chunks": chunks, "tiles": tiles, "stage_bytes": stage,
                    "smem_bytes": smem, "ctas_per_sm": ctas,
                    "grid": min(tiles, sms * ctas)}
    return {"path": "rowwise", "qpc": 1, "rps": r, "chunks": 1, "tiles": b,
            "stage_bytes": 4 * d, "smem_bytes": 4 * d, "ctas_per_sm": None,
            "grid": b}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gather_score(
    corpus_i8: torch.Tensor,   # [N, D] int8
    ids: torch.Tensor,         # [B, R] int32 (or int64), each in [0, N)
    queries: torch.Tensor,     # [B, D] f32
    qb: int = 4,
) -> torch.Tensor:
    """scores [B, R] f32 = bf16(queries) . corpus_i8[ids], float32 sums.
    CUDA tensors launch the CUDA kernel `launch_plan` chooses; CPU tensors
    run the plain version. `qb` (the reference's queries per Pallas
    program) is kept for callers written against the reference and is
    ignored: the port has no B % qb rule. An id outside [0, N) scores
    NaN on the card."""
    del qb
    _check(corpus_i8, ids, queries)
    queries = queries.float()
    if queries.device.type == "cpu":
        return gather_score_plain(corpus_i8, ids, queries)

    from leann_tpu_torch.ops import _cuda

    lib = _cuda.load("gather_score")
    n, d = corpus_i8.shape
    b, r = ids.shape
    out = torch.empty((b, r), dtype=torch.float32, device=queries.device)
    if b == 0 or r == 0:
        return out
    corpus, ids32, q = (t.contiguous() for t in (
        corpus_i8, ids.to(torch.int32), queries))
    plan = launch_plan(b, r, d, _sm_count(q.device.index or 0),
                       corpus.data_ptr() % 16 == 0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if plan["path"] == "staged":
            if q.data_ptr() % 16:
                q = q.clone()          # the kernel reads 16-byte chunks
            err = lib.leann_gather_score(
                corpus.data_ptr(), ids32.data_ptr(), q.data_ptr(),
                out.data_ptr(), n, b, r, d, plan["qpc"], plan["rps"],
                plan["chunks"], plan["grid"], plan["stage_bytes"], stream)
        else:
            w, g = _lanes(corpus, 1, loads=(4,))
            err = lib.leann_gather_score_rowwise(
                corpus.data_ptr(), ids32.data_ptr(), q.data_ptr(),
                out.data_ptr(), n, b, r, d, w, g, stream)
    _cuda.check(lib, err, "gather_score")
    _cuda.count_launch(gather_score, plan["path"])
    return out


gather_score.launches = 0
gather_score.paths = {"staged": 0, "rowwise": 0}
