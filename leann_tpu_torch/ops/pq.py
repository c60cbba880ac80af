"""Product quantization: train / encode / reconstruct / LUTs (port of
`leann_tpu/ops/pq.py`).

Purpose: shrink per-vector traversal payloads so the PQ graph kernel
(`ops/pq_beam.py`) can inline neighbour codes: m bytes per neighbour
instead of the D bytes of the int8 inline records, with no D % 128
restriction, since queries only enter through lookup tables.

Scoring model (ADC, asymmetric distance computation): a query builds a
lookup table LUT[j, c] = <q_j, C[j, c]> per subspace j; the approximate
dot of q with any encoded vector is sum_j LUT[j, code_j]. For l2 the
traversal score is 2 * adc_dot - |x_hat|^2, folded into the LUT.

Host API as in the reference: numpy in, numpy out. The k-means and
encode products run on `device` (default cuda) as plain float32
matmuls (TF32 off, the PyTorch default); `torch.argmax` returns the
first maximum, as `jnp.argmax` does, so codes match the reference's up
to float32 summation-order near-ties.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from leann_tpu_torch.device import DeviceLike, resolve_device


def _kmeans_1sub(
    x: torch.Tensor,       # [S, dsub] f32
    init: torch.Tensor,    # [ksub, dsub] f32
    ksub: int,
    iters: int,
) -> torch.Tensor:
    """Lloyd's k-means for one subspace. Empty clusters keep their old
    centroid (they can re-acquire points later). The centroid sums are a
    one-hot matmul, as in the reference (deterministic, unlike atomics)."""
    cent = init
    for _ in range(iters):
        csq = (cent * cent).sum(1)                           # [K]
        # argmin ||x - c||^2 = argmax 2 x.c - |c|^2
        scores = 2.0 * (x @ cent.T) - csq[None, :]           # [S, K]
        assign = torch.argmax(scores, dim=1)                 # [S]
        onehot = torch.nn.functional.one_hot(assign, ksub).to(torch.float32)
        sums = onehot.T @ x                                  # [K, dsub]
        counts = onehot.sum(0)                               # [K]
        new = sums / torch.clamp_min(counts, 1.0)[:, None]
        cent = torch.where((counts > 0)[:, None], new, cent)
    return cent


def train_pq(
    sample: np.ndarray,   # [S, D] f32 training sample
    m: int,
    ksub: int = 256,
    iters: int = 12,
    seed: int = 0,
    device: DeviceLike = None,
) -> np.ndarray:
    """Train per-subspace codebooks. Returns [m, ksub, dsub] f32.
    D % m must be 0. The initial centroids are the reference's numpy
    draws."""
    dev = resolve_device(device)
    sample = np.asarray(sample, np.float32)
    s, d = sample.shape
    if d % m:
        raise ValueError(f"D={d} not divisible by m={m}")
    dsub = d // m
    rng = np.random.default_rng(seed)
    sub = np.ascontiguousarray(sample.reshape(s, m, dsub).transpose(1, 0, 2))
    books = np.empty((m, ksub, dsub), np.float32)
    for j in range(m):
        # corpora smaller than ksub duplicate init centroids; kmeans
        # keeps empty clusters at their old centroid so shapes (and the
        # uint8 code domain) stay fixed
        init = sub[j][rng.choice(s, ksub, replace=s < ksub)]
        books[j] = _kmeans_1sub(
            torch.from_numpy(sub[j]).to(dev), torch.from_numpy(init).to(dev),
            ksub, iters).cpu().numpy()
    return books


def encode_pq(
    vectors: np.ndarray,   # [N, D] f32
    books: np.ndarray,     # [m, ksub, dsub]
    chunk: int = 262144,
    device: DeviceLike = None,
) -> np.ndarray:
    """Encode to [N, m] uint8 codes (ksub <= 256)."""
    dev = resolve_device(device)
    n, d = vectors.shape
    m, ksub, dsub = books.shape
    if ksub > 256:
        raise ValueError("uint8 codes need ksub <= 256")
    books_t = torch.from_numpy(np.asarray(books, np.float32)).to(dev)
    csq = (books_t * books_t).sum(2)                         # [m, K]
    out = np.empty((n, m), np.uint8)
    for i in range(0, n, chunk):
        blk = torch.from_numpy(np.array(      # a copy: `vectors` may be
            vectors[i : i + chunk], np.float32    # a read-only memmap
        ).reshape(-1, m, dsub)).to(dev)
        scores = 2.0 * torch.einsum("cmd,mkd->cmk", blk, books_t) - csq[None]
        out[i : i + chunk] = torch.argmax(scores, dim=2).to(
            torch.uint8).cpu().numpy()
    return out


def reconstruct_pq(
    codes: np.ndarray,     # [N, m] uint8
    books: np.ndarray,     # [m, ksub, dsub]
    chunk: int = 1_000_000,
) -> np.ndarray:
    """Decode x_hat [N, D] f32 (a host gather, as in the reference)."""
    n, m = codes.shape
    _, _, dsub = books.shape
    out = np.empty((n, m * dsub), np.float32)
    for i in range(0, n, chunk):
        c = codes[i : i + chunk].astype(np.int64)
        blk = books[np.arange(m)[None, :], c]               # [C, m, dsub]
        out[i : i + chunk] = blk.reshape(-1, m * dsub)
    return out


def adc_lut(
    queries: torch.Tensor,  # [B, D] f32
    books: torch.Tensor,    # [m, ksub, dsub] f32
) -> torch.Tensor:
    """Per-query ADC tables: LUT[b, j, c] = <q_bj, C[j, c]>. The
    approximate dot with code row `code` is sum_j LUT[b, j, code_j]."""
    b, _ = queries.shape
    m, _, dsub = books.shape
    return torch.einsum("bmd,mkd->bmk", queries.reshape(b, m, dsub), books)


# ----------------------------------------------------- residual (two-level)
#
# Single-level ADC cannot rank clustered corpora at scale: the
# quantization error exceeds the within-cluster score spread. The coarse
# quantizer is itself a product quantizer (mc subspaces), the fine one
# encodes the residual, and the exact |x_hat|^2 is stored per node,
# quantized to 16 bits split across two extra 8-bit code columns whose
# "LUTs" are constant affine ramps. Every column is then a uniform
# (ksub <= 256, 8-bit) ADC subspace and the traversal kernel runs
# unchanged:
#
#   score = sum_j LUT[j, code_j] = 2<q, c_a> + 2<q, r_hat> - |x_hat|^2  (l2)


def train_residual_pq(
    sample: np.ndarray,   # [S, D] f32
    mc: int,
    mf: int,
    ksub: int = 256,
    iters: int = 12,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Train coarse-PQ books [mc, ksub, d/mc] on the sample, then fine
    books [mf, ksub, d/mf] on the coarse residuals."""
    books_c = train_pq(sample, m=mc, ksub=ksub, iters=iters, seed=seed,
                       device=device)
    codes_c = encode_pq(sample, books_c, device=device)
    resid = sample - reconstruct_pq(codes_c, books_c)
    books_f = train_pq(resid, m=mf, ksub=ksub, iters=iters, seed=seed + 1,
                       device=device)
    return books_c, books_f


def encode_residual_pq(
    vectors: np.ndarray,   # [N, D] f32
    books_c: np.ndarray,
    books_f: np.ndarray,
    chunk: int = 262144,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode to ([N, mc+mf] uint8 codes, [N] f32 exact |x_hat|^2)."""
    n, d = vectors.shape
    mc = books_c.shape[0]
    mf = books_f.shape[0]
    codes = np.empty((n, mc + mf), np.uint8)
    nsq = np.empty(n, np.float32)
    for i in range(0, n, chunk):
        blk = vectors[i : i + chunk]
        cc = encode_pq(blk, books_c, chunk=chunk, device=device)
        xc = reconstruct_pq(cc, books_c, chunk=chunk)
        cf = encode_pq(blk - xc, books_f, chunk=chunk, device=device)
        xh = xc + reconstruct_pq(cf, books_f, chunk=chunk)
        codes[i : i + chunk, :mc] = cc
        codes[i : i + chunk, mc:] = cf
        nsq[i : i + chunk] = np.einsum(
            "nd,nd->n", xh, xh, dtype=np.float64).astype(np.float32)
    return codes, nsq


def reconstruct_residual_pq(
    codes: np.ndarray,     # [N, mc+mf] uint8
    books_c: np.ndarray,
    books_f: np.ndarray,
    chunk: int = 1_000_000,
) -> np.ndarray:
    """x_hat = coarse recon + fine residual recon."""
    mc = books_c.shape[0]
    return (reconstruct_pq(codes[:, :mc], books_c, chunk=chunk)
            + reconstruct_pq(codes[:, mc:], books_f, chunk=chunk))


def quantize_norms(nsq: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """|x_hat|^2 -> ([N, 2] uint8 (hi, lo), offset, scale) with
    nsq ~= offset + (hi * 256 + lo) * scale (u16 grid over the range;
    max error scale/2, orders below the ADC noise floor)."""
    lo_v = float(nsq.min())
    hi_v = float(nsq.max())
    scale = max((hi_v - lo_v) / 65535.0, 1e-20)
    q = np.clip(np.round((nsq - lo_v) / scale), 0, 65535).astype(np.uint16)
    out = np.stack([(q >> 8).astype(np.uint8), (q & 255).astype(np.uint8)],
                   axis=1)
    return out, lo_v, scale


def _embed_books(books: np.ndarray, d: int, d_off: int) -> np.ndarray:
    """[m, ksub, dsub] -> [m, ksub, d] with subspace j's centroids
    placed at columns [d_off + j*dsub, ...) and zeros elsewhere, so
    LUT[j, c] = <q_full, B[j, c]>."""
    m, ksub, dsub = books.shape
    out = np.zeros((m, ksub, d), np.float32)
    for j in range(m):
        out[j, :, d_off + j * dsub : d_off + (j + 1) * dsub] = books[j]
    return out


def adc_affine(
    d: int,
    metric: str,              # "l2" | "ip"
    books_c: Optional[np.ndarray],   # None => single-level PQ
    books_f: np.ndarray,
    ksub: int,
    norm_offset: float = 0.0,
    norm_scale: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Unified ADC-LUT affine form: LUT[b] = q_b @ W^T + B, i.e.
    luts[b, j, c] = <q_b, W[j, c]> + B[j, c].

    single-level:  W = C (ip) or 2C (l2),  B = 0 (ip) or -|C|^2 (l2)
    residual(l2):  W = [2*Cc | 2*Cf | 0 | 0],
                   B = [0 | 0 | -(256c*scale) - offset | -(c*scale)]
    residual(ip):  W = [Cc | Cf],  B = 0  (no norm columns needed)

    Returns (W [mt, ksub, d] f32, B [mt, ksub] f32)."""
    scale2 = 2.0 if metric == "l2" else 1.0
    if books_c is None:
        w = _embed_books(np.asarray(books_f, np.float32), d, 0) * scale2
        b = np.zeros(w.shape[:2], np.float32)
        if metric == "l2":
            b -= np.sum(
                np.asarray(books_f, np.float64) ** 2, axis=2
            ).astype(np.float32)
        return w, b
    wc = _embed_books(np.asarray(books_c, np.float32), d, 0) * scale2
    wf = _embed_books(np.asarray(books_f, np.float32), d, 0) * scale2
    parts_w = [wc, wf]
    parts_b = [np.zeros(wc.shape[:2], np.float32),
               np.zeros(wf.shape[:2], np.float32)]
    if metric == "l2":
        c = np.arange(ksub, dtype=np.float32)
        b_hi = (-(c * 256.0) * norm_scale - norm_offset)[None, :]
        b_lo = (-c * norm_scale)[None, :]
        parts_w += [np.zeros((2, ksub, d), np.float32)]
        parts_b += [np.concatenate([b_hi, b_lo], axis=0)]
    return (np.concatenate(parts_w, axis=0),
            np.concatenate(parts_b, axis=0))


# ------------------------------------------------------------------- OPQ
#
# Optimized Product Quantization (Ge et al., CVPR 2013, OPQ-NP): learn an
# orthogonal rotation R that redistributes variance across the m
# subspaces before PQ, by alternating (1) PQ retrain on the rotated
# sample and (2) the Procrustes update R = U V^T from SVD(X^T Y). Codes
# and records are built in the rotated frame; the rotation folds into
# the affine LUT operands, so serving costs nothing per record.


def train_opq(
    sample: np.ndarray,   # [S, D] f32
    m: int,
    ksub: int = 256,
    iters: int = 12,
    opq_iters: int = 8,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (rot [D, D] f32 orthogonal, books [m, ksub, dsub]).
    Encode with `encode_pq(x @ rot, books)`; decode back to the
    original frame with `reconstruct_pq(codes, books) @ rot.T`. The SVD
    runs on the host in float64, as in the reference."""
    x = np.ascontiguousarray(sample, dtype=np.float32)
    s, d = x.shape
    rot = np.eye(d, dtype=np.float32)
    for _ in range(opq_iters):
        xr = x @ rot
        # cheap inner k-means while alternating; full train at the end
        books = train_pq(xr, m=m, ksub=ksub, iters=max(4, iters // 2),
                         seed=seed, device=device)
        y = reconstruct_pq(encode_pq(xr, books, device=device), books)
        # orthogonal R maximizing trace(R^T X^T Y): R = U V^T
        u, _, vt = np.linalg.svd(
            x.T.astype(np.float64) @ y.astype(np.float64))
        rot = (u @ vt).astype(np.float32)
    books = train_pq(x @ rot, m=m, ksub=ksub, iters=iters, seed=seed,
                     device=device)
    return rot, books
