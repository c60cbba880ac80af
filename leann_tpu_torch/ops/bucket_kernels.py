"""Bucket-scan kernels of the IVF family (port of
`leann_tpu/ops/pallas_kernels.py`; the port has no Pallas, so the module
is named for what it holds).

  ivf_bucket_dots      (B4) bf16 dot products of each query with the
                       rows of its probed buckets, [P, B, cap]; the CUDA
                       kernel `csrc/ivf_bucket_dots.cu` runs on CUDA
                       tensors. Its caller is `ivf_search_pallas`, which
                       `IvfEngine.search_pallas` runs.
  ivf8_bucket_scores   (B2) residual-int8 bucket scores (centroid term +
                       scale * int8 dot, l2 fold, -1 slots to -inf),
                       [B, P, cap]; the CUDA kernel `csrc/ivf8_scan.cu`
                       runs on CUDA tensors. Its caller is
                       `IvfInt8Engine` under LEANN_IVF8_PALLAS=1.

Each wrapper runs its plain PyTorch version (`*_plain`) on CPU tensors
and raises on any other device. The reference's names (`search_pallas`,
`ivf_search_pallas`, LEANN_IVF8_PALLAS) are kept so that callers and
tests written for its API pair up. The reference pads cap and D to its
TPU tiling and needs B % 8 == 0; the kernels here take unpadded
[K', cap, D] tables and any B, and the plain versions take either.

Sums: the plain versions are float32 matrix products; the kernels add
the same exact products (bf16 x bf16 and int8 x bf16 fit float32) in
another order, so the two agree to float32 rounding of the sums, about
1e-7 x |q| x |row| (`chip_smoke.py` holds them to 1e-5 x that).
"""

from __future__ import annotations

from typing import Tuple

import torch

from leann_tpu_torch.ops.distance import NEG_INF, pairwise_scores, topk_stable

# float32 elements per query chunk of a plain version's gathered rows
_PLAIN_CHUNK = 1 << 26


def _query_chunk(cap: int, d: int) -> int:
    return max(1, _PLAIN_CHUNK // max(1, cap * d))


def _lanes(table: torch.Tensor, elem_bytes: int,
           loads: Tuple[int, ...] = (16,)) -> Tuple[int, int]:
    """(W, G) of a kernel launch: W elements per lane load (the first
    width of `loads`, in bytes, that the rows' length and alignment
    allow, else 1 element) and G lanes per row, the largest power of two
    <= min(32, D / W)."""
    d = table.shape[-1]
    w = 1
    for nbytes in loads:
        if (d * elem_bytes) % nbytes == 0 and table.data_ptr() % nbytes == 0:
            w = nbytes // elem_bytes
            break
    g = 1
    while g * 2 <= min(32, d // w):
        g *= 2
    return w, g


def _check(queries, probe, tables, dtypes):
    b, d = queries.shape
    if probe.dim() != 2 or probe.shape[0] != b:
        raise ValueError(f"probe must be [B, P] with B={b}")
    if probe.shape[1] > 65535:
        raise ValueError("at most 65535 probes per query")
    for t, dt in zip((queries, probe) + tables,
                     (torch.float32, torch.int32) + dtypes):
        if t.dtype != dt:
            raise TypeError(f"expected {dt}, got {t.dtype}")
        if t.device != queries.device:
            raise ValueError("all inputs must be on one device")
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {queries.device}")


# ------------------------------------------------------------ B4: bf16 dots


def ivf_bucket_dots_plain(queries, probe, bucket_vecs) -> torch.Tensor:
    """Plain PyTorch version of `ivf_bucket_dots`: float32 products of the
    bf16-rounded queries with the gathered bf16 rows."""
    b, _ = queries.shape
    p = probe.shape[1]
    _, cap, d = bucket_vecs.shape
    q = queries.to(torch.bfloat16).float()
    out = torch.empty((p, b, cap), dtype=torch.float32, device=queries.device)
    qc = _query_chunk(cap, d)
    for j in range(p):
        for s in range(0, b, qc):
            rows = bucket_vecs[probe[s : s + qc, j].long()].float()
            out[j, s : s + qc] = torch.einsum("bcd,bd->bc", rows, q[s : s + qc])
    return out


def ivf_bucket_dots(
    queries: torch.Tensor,      # [B, D] f32
    probe: torch.Tensor,        # [B, P] int32 bucket ids
    bucket_vecs: torch.Tensor,  # [K', cap, D] bf16
) -> torch.Tensor:
    """Returns dots [P, B, cap] f32: bf16(q_b) . bucket_vecs[probe[b, p]],
    float32 accumulation. CUDA tensors launch the CUDA kernel
    (`csrc/ivf_bucket_dots.cu`); CPU tensors run the plain version."""
    if bucket_vecs.dim() != 3 or bucket_vecs.shape[2] != queries.shape[1]:
        raise ValueError("bucket_vecs must be [K', cap, D]")
    _check(queries, probe, (bucket_vecs,), (torch.bfloat16,))
    if queries.device.type == "cpu":
        return ivf_bucket_dots_plain(queries, probe, bucket_vecs)

    from leann_tpu_torch.ops import _cuda

    lib = _cuda.load("ivf_bucket_dots")
    b, d = queries.shape
    p = probe.shape[1]
    k, cap, _ = bucket_vecs.shape
    q, pr, vecs = (t.contiguous() for t in (queries, probe, bucket_vecs))
    w, g = _lanes(vecs, 2)
    out = torch.empty((p, b, cap), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.leann_ivf_bucket_dots(
            q.data_ptr(), pr.data_ptr(), vecs.data_ptr(), out.data_ptr(),
            b, p, k, cap, d, w, g, stream)
    _cuda.check(lib, err, "ivf_bucket_dots")
    ivf_bucket_dots.launches += 1
    return out


ivf_bucket_dots.launches = 0


def ivf_search_pallas(
    queries,           # [B, D] f32
    centroids,         # [K', D] f32
    bucket_ids_pad,    # [K', cap] int (pad = sentinel)
    bucket_vecs_bf16,  # [K', cap, D] bf16
    bucket_sq_pad,     # [K', cap] f32
    k: int,
    nprobe: int,
    metric: str,
    sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centroid GEMM -> top-nprobe -> kernel B4 -> l2 fold -> sentinel
    mask -> one top-k over the flattened [B, P*cap] candidates. Returns
    (top_scores [B, k], top_ids [B, k] int64, -1 for empty slots)."""
    b = queries.shape[0]
    cap = bucket_ids_pad.shape[1]
    c_scores = pairwise_scores(queries, centroids, metric)
    _, probe = topk_stable(c_scores, nprobe)                 # [B, P]
    dots = ivf_bucket_dots(queries, probe.to(torch.int32),
                           bucket_vecs_bf16)                  # [P, B, cap]
    dots = dots.transpose(0, 1)                               # [B, P, cap]
    ids = bucket_ids_pad[probe].long()                        # [B, P, cap]
    scores = 2.0 * dots - bucket_sq_pad[probe] if metric == "l2" else dots
    scores = scores.reshape(b, nprobe * cap)
    ids = ids.reshape(b, nprobe * cap)
    scores = torch.where(ids == sentinel, NEG_INF, scores)
    ids = torch.where(ids == sentinel, -1, ids)
    top_scores, pos = topk_stable(scores, k)
    return top_scores, torch.gather(ids, 1, pos)


# ------------------------------------------------------- B2: residual int8


def ivf8_bucket_scores_plain(queries, probe, payload, scale, nsq, ids, cent,
                             metric: str) -> torch.Tensor:
    """Plain PyTorch version of `ivf8_bucket_scores`: the reference's
    `<q, c> + scale * <bf16 q, r8>` with float32 products and sums."""
    b, _ = queries.shape
    p = probe.shape[1]
    _, cap, d = payload.shape
    q = queries.float()
    q_bf = q.to(torch.bfloat16).float()
    out = torch.empty((b, p, cap), dtype=torch.float32, device=q.device)
    qc = _query_chunk(cap, d)
    for j in range(p):
        for s in range(0, b, qc):
            c = probe[s : s + qc, j].long()
            rdots = torch.einsum("bcd,bd->bc", payload[c].float(),
                                 q_bf[s : s + qc])
            cdot = (cent[c] * q[s : s + qc]).sum(1)
            dots = cdot[:, None] + rdots * scale[c]
            sc = 2.0 * dots - nsq[c] if metric == "l2" else dots
            out[s : s + qc, j] = torch.where(ids[c] == -1, NEG_INF, sc)
    return out


def ivf8_bucket_scores(
    queries: torch.Tensor,   # [B, D] f32
    probe: torch.Tensor,     # [B, P] int32 bucket ids
    payload: torch.Tensor,   # [K', cap, D] int8 residuals
    scale: torch.Tensor,     # [K', cap] f32
    nsq: torch.Tensor,       # [K', cap] f32
    ids: torch.Tensor,       # [K', cap] int32 (-1 = empty slot)
    cent: torch.Tensor,      # [K', D] f32 bucket centroids
    metric: str,
) -> torch.Tensor:
    """Residual-int8 bucket scan. Returns masked scores [B, P, cap] f32:
    `<q, c> + scale * <bf16(q), r8>`, for l2 `2 * that - nsq`, -inf where
    ids == -1. CUDA tensors launch the CUDA kernel (`csrc/ivf8_scan.cu`);
    CPU tensors run the plain version."""
    if payload.dim() != 3:
        raise ValueError("payload must be [K', cap, D]")
    kp, cap, d = payload.shape
    if d != queries.shape[1] or scale.shape != (kp, cap) or \
            nsq.shape != (kp, cap) or ids.shape != (kp, cap) or \
            cent.shape != (kp, d):
        raise ValueError("payload [K', cap, D], scale/nsq/ids [K', cap] and "
                         "cent [K', D] expected")
    if metric not in ("l2", "ip"):
        raise ValueError(f"metric must be l2 or ip (got {metric!r})")
    _check(queries, probe, (payload, scale, nsq, ids, cent),
           (torch.int8, torch.float32, torch.float32, torch.int32,
            torch.float32))
    if queries.device.type == "cpu":
        return ivf8_bucket_scores_plain(queries, probe, payload, scale, nsq,
                                        ids, cent, metric)

    from leann_tpu_torch.ops import _cuda

    lib = _cuda.load("ivf8_scan")
    b = queries.shape[0]
    p = probe.shape[1]
    ts = [t.contiguous() for t in (queries, probe, payload, scale, nsq, ids,
                                   cent)]
    w, g = _lanes(ts[2], 1)
    out = torch.empty((b, p, cap), dtype=torch.float32, device=queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        err = lib.leann_ivf8_bucket_scores(
            *(t.data_ptr() for t in ts), out.data_ptr(), b, p, kp, cap, d,
            w, g, int(metric == "l2"), stream)
    _cuda.check(lib, err, "ivf8_bucket_scores")
    ivf8_bucket_scores.launches += 1
    return out


ivf8_bucket_scores.launches = 0
