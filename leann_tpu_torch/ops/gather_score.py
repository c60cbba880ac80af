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

Sums: int8 x bf16 products are exact in float32. The plain version adds
them in a matrix product's order, the kernel in lane-group order, so the
two agree to float32 rounding of the sums, about 1e-7 x |q| x |row|
(`chip_smoke.py` holds them to 1e-5 x that).
"""

from __future__ import annotations

import torch

from leann_tpu_torch.ops.bucket_kernels import _PLAIN_CHUNK, _lanes


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


def gather_score(
    corpus_i8: torch.Tensor,   # [N, D] int8
    ids: torch.Tensor,         # [B, R] int32 (or int64), each in [0, N)
    queries: torch.Tensor,     # [B, D] f32
    qb: int = 4,
) -> torch.Tensor:
    """scores [B, R] f32 = bf16(queries) . corpus_i8[ids], float32 sums.
    CUDA tensors launch the CUDA kernel; CPU tensors run the plain
    version. `qb` (the reference's queries per Pallas program) is kept
    for callers written against the reference and is ignored: one CTA
    serves one query, so no B % qb rule exists. Ids are trusted to lie in
    [0, N), as in the reference."""
    del qb
    _check(corpus_i8, ids, queries)
    queries = queries.float()
    if queries.device.type == "cpu":
        return gather_score_plain(corpus_i8, ids, queries)

    from leann_tpu_torch.ops import _cuda

    lib = _cuda.load("gather_score")
    n, d = corpus_i8.shape
    b, r = ids.shape
    corpus, ids32, q = (t.contiguous() for t in (
        corpus_i8, ids.to(torch.int32), queries))
    w, g = _lanes(corpus, 1, loads=(16, 4))
    out = torch.empty((b, r), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.leann_gather_score(
            corpus.data_ptr(), ids32.data_ptr(), q.data_ptr(), out.data_ptr(),
            n, b, r, d, w, g, stream)
    _cuda.check(lib, err, "gather_score")
    _cuda.count_launch(gather_score)
    return out


gather_score.launches = 0
