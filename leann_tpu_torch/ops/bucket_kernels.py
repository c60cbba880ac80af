"""Bucket-scan kernels of the IVF family (port of
`leann_tpu/ops/pallas_kernels.py`; the port has no Pallas, so the module
is named for what it holds).

  ivf_bucket_dots      (B4) bf16 dot products of each query with the
                       rows of its probed buckets, [P, B, cap]; the CUDA
                       kernel `csrc/ivf_bucket_dots.cu` runs on CUDA
                       tensors. Its callers are `ops/ivf.py:ivf_search` on
                       the card (what `IvfSearcher` serves) and
                       `ivf_search_pallas`, which `IvfEngine.search_pallas`
                       runs; `ops/ivf_topc.py` selects from its dots.
  ivf8_bucket_scores   (B2) residual-int8 bucket scores (centroid term +
                       scale * int8 dot, l2 fold, -1 slots to -inf),
                       [B, P, cap]; the CUDA kernel `csrc/ivf8_scan.cu`
                       runs on CUDA tensors. Its caller is
                       `IvfInt8Engine` under LEANN_IVF8_PALLAS=1.
  bucket_worklist      the work list both kernels take: the (query,
                       probe) pairs grouped by bucket.

Each wrapper runs its plain PyTorch version (`*_plain`) on CPU tensors
and raises on any other device. The reference's names (`search_pallas`,
`ivf_search_pallas`, LEANN_IVF8_PALLAS) are kept so that callers and
tests written for its API pair up. The reference pads cap and D to its
TPU tiling and needs B % 8 == 0; the kernels here take unpadded
[K', cap, D] tables and any B, and the plain versions take either.

Both kernels are bucket-major (`csrc/bucket_scan.cuh`): one CTA per item
of a work list reads its bucket once for up to `qmax` (32) of the
queries that probe it. `bucket_worklist` defines the list: the flattened
probes sorted by bucket (stably; probes outside [0, K') as one more
group, K', whose items the kernels answer with NaN rows), each bucket's
pairs cut into items of at most `qmax`, so that a bucket every query
probes spreads over many SMs. The grid has ceil(B*P / qmax) + min(K',
B*P) items, enough for any probes, sized from shapes; the unused tail
has count 0. On the card the wrapper sorts the keys with torch (the
same `_sorted_keys`) and the kernel library turns them into the items in
one launch, equal to `bucket_worklist`'s (`tests/test_torch_cuda.py`);
the torch ops after the sort, some 20 launches, would cost more host
time than B4 takes on the card. Nothing reads a count back to the host.

Sums: the plain versions are float32 matrix products; the kernels add
the same exact products on the tensor cores in another order (bf16 x
bf16; for B2 int8 x bf16(q) scaled by a power of two into fp16, undone
exactly after the sum), so the two agree to float32 rounding of the
sums, about 1e-7 x |q| x |row| (`chip_smoke.py` holds them to 1e-5 x
that).
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


def _smem_stride(nbytes: int, elem: int) -> int:
    s = -(-nbytes // 16) * 16
    while (s % 128 != 64) if elem == 2 else (s % 64 != 32):
        s += 16
    return s


def _qmax(d: int) -> int:
    """Pairs per work item at width d: 32, halved while the item's
    queries pass 32 KiB of shared memory, at least 8 (the kernels'
    `bucket_scan::qmax_for`, which checks that the two agree)."""
    stride = _smem_stride(-(-d // 32) * 32 * 2, 2)
    q = 32
    while q > 8 and q * stride > 32768:
        q //= 2
    return q


def _n_items(n: int, n_buckets: int, qmax: int) -> int:
    """The work list's length: enough items for any probes."""
    return -(-n // qmax) + min(n_buckets, n)


def _sorted_keys(probe: torch.Tensor,
                 n_buckets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys sorted stably, their positions b*P + j): the flattened
    probes, n_buckets for a probe outside [0, n_buckets)."""
    key = probe.reshape(-1).clamp(-1, n_buckets).remainder(n_buckets + 1)
    return torch.sort(key, stable=True)


def bucket_worklist(probe: torch.Tensor, n_buckets: int,
                    qmax: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (query, probe) pairs of `probe` [B, P] int32 grouped by
    bucket, on probe's device, with no read back to the host. Returns
    (pairs [B*P] int64: pair ids b*P + j, by bucket, stable; items [G, 3]
    int32: (bucket, first position in `pairs`, count), G = `_n_items`).
    Each item holds one bucket and at most `qmax` pairs; probes outside
    [0, n_buckets) are listed under bucket n_buckets; items past the last
    are (n_buckets, B*P, 0). On the card the kernels build the same items
    from the same sort in one launch (`csrc/bucket_scan.cuh`)."""
    n = probe.numel()
    dev = probe.device
    skey, pairs = _sorted_keys(probe, n_buckets)
    # bounds[c]: the first position of a key >= c; bounds[n_buckets + 1] = n
    bounds = torch.searchsorted(
        skey, torch.arange(n_buckets + 2, device=dev, dtype=skey.dtype),
        out_int32=True)
    counts = bounds[1:] - bounds[:-1]                      # [K' + 1]
    chunks = (counts + (qmax - 1)) // qmax
    ends = torch.cumsum(chunks, 0, dtype=torch.int32)      # items so far
    it = torch.arange(_n_items(n, n_buckets, qmax), device=dev,
                      dtype=torch.int32)
    grp = torch.searchsorted(ends, it, right=True, out_int32=True)
    live = grp <= n_buckets
    grp = grp.clamp(max=n_buckets)
    k = (it - (ends[grp] - chunks[grp])) * qmax            # pairs before
    items = torch.stack([grp, torch.where(live, bounds[grp] + k, n),
                         torch.where(live, counts[grp] - k, 0).clamp(
                             max=qmax)], 1)
    return pairs, items.to(torch.int32)


def _vec(table: torch.Tensor, elem_bytes: int) -> int:
    """1 when the kernel may copy the table by bulk copies (rows of a
    multiple of 16 bytes, a 16-byte aligned table)."""
    d = table.shape[-1]
    return int((d * elem_bytes) % 16 == 0 and table.data_ptr() % 16 == 0)


def ivf_bucket_dots_ctas_per_sm(d: int) -> int:
    """Resident CTAs per SM of kernel B4 at width d (on the card)."""
    from leann_tpu_torch.ops import _cuda

    return _cuda.load("ivf_bucket_dots").leann_ivf_bucket_dots_ctas_per_sm(d)


def ivf8_bucket_scores_ctas_per_sm(d: int) -> int:
    """Resident CTAs per SM of kernel B2 at width d (on the card)."""
    from leann_tpu_torch.ops import _cuda

    return _cuda.load("ivf8_scan").leann_ivf8_bucket_scores_ctas_per_sm(d)


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
    q, vecs = queries.contiguous(), bucket_vecs.contiguous()
    qmax = _qmax(d)
    g = _n_items(b * p, k, qmax)
    with torch.cuda.device(q.device):
        skey, pairs = _sorted_keys(probe, k)
        scratch = torch.empty(k + 2 + 3 * g, dtype=torch.int32,
                              device=q.device)
        out = torch.empty((p, b, cap), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.leann_ivf_bucket_dots(
            q.data_ptr(), skey.data_ptr(), pairs.data_ptr(),
            scratch.data_ptr(), scratch[k + 2:].data_ptr(), vecs.data_ptr(),
            out.data_ptr(), b, p, k, cap, d, g, qmax, _vec(vecs, 2), stream)
    _cuda.check(lib, err, "ivf_bucket_dots")
    _cuda.count_launch(ivf_bucket_dots)
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
    """Centroid GEMM -> top-nprobe -> kernel B4 -> `ivf_topc` (the l2
    fold, the sentinel mask and one top-k over the flattened [B, P*cap]
    candidates). Returns (top_scores [B, k], top_ids [B, k] int64, -1 for
    empty slots)."""
    from leann_tpu_torch.ops.ivf_topc import ivf_topc

    c_scores = pairwise_scores(queries, centroids, metric)
    probe = topk_stable(c_scores, nprobe)[1].to(torch.int32)  # [B, P]
    dots = ivf_bucket_dots(queries, probe, bucket_vecs_bf16)  # [P, B, cap]
    return ivf_topc(dots, probe, bucket_sq_pad, bucket_ids_pad, k, metric,
                    sentinel)


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
    q, pay, *meta = (t.contiguous() for t in (queries, payload, scale, nsq,
                                              ids, cent))
    qmax = _qmax(d)
    g = _n_items(b * p, kp, qmax)
    with torch.cuda.device(q.device):
        skey, pairs = _sorted_keys(probe, kp)
        scratch = torch.empty(kp + 2 + 3 * g, dtype=torch.int32,
                              device=q.device)
        out = torch.empty((b, p, cap), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.leann_ivf8_bucket_scores(
            q.data_ptr(), skey.data_ptr(), pairs.data_ptr(),
            scratch.data_ptr(), scratch[kp + 2:].data_ptr(), pay.data_ptr(),
            *(t.data_ptr() for t in meta), out.data_ptr(), b, p, kp, cap, d,
            g, qmax, _vec(pay, 1), int(metric == "l2"), stream)
    _cuda.check(lib, err, "ivf8_bucket_scores")
    _cuda.count_launch(ivf8_bucket_scores)
    return out


ivf8_bucket_scores.launches = 0
