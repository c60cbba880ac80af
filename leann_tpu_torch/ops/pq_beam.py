"""PQ fused traversal: the whole beam search with inline neighbour PQ
codes (port of `leann_tpu/ops/pq_beam.py`).

The same search as `ops/fused_beam.py`, but each record carries its
neighbours' product-quantization codes instead of their int8 vectors:

  record i32 [N+1, CP, 128]
    plane 0        : neighbour ids in lanes [0, R); code words in the
                     free tail
    planes 1..CP-1 : code words, subspace-major: subspace j's R codes
                     sit in lps = R/cpl consecutive words at
                     slots[j] = (plane, offset), cpl codes per word
                     (8 for 4-bit, 4 for 8-bit); neighbour i's code is
                     in word i // cpl at bit shift (i % cpl) * bits

Queries enter only through ADC lookup tables (LUT [B, m*ksub] f32 with
the metric folded in, `ops/pq.adc_affine`), so D % 128 need not hold:
this is the engine `GraphSearcher` picks for 96-d corpora (DEEP). PQ
scores steer the search only; the engine rescores the final beam and the
visited log exactly against the corpus.

`pq_beam_search` launches the hand-written CUDA kernel
`csrc/pq_beam.cu` for CUDA tensors and runs `pq_beam_search_plain`, which
follows the Pallas kernel hop by hop, for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from leann_tpu_torch.device import DeviceLike, resolve_device
from leann_tpu_torch.ops.beam import _rescore, seed_pool_size
from leann_tpu_torch.ops.fused_beam import (
    LANES, NEG_INF, _bitonic_desc, _dedup_candidates, _first_k_unexpanded,
    _group_any, _member, _sizes,
)
from leann_tpu_torch.ops.pq import (
    adc_affine, encode_pq, encode_residual_pq, quantize_norms,
    reconstruct_pq, reconstruct_residual_pq, train_pq, train_residual_pq,
)


# ------------------------------------------------------------------ pack


def pq_layout(r: int, m: int, bits: int):
    """Record lane layout: (cpl, lps, slots, cp).

    cpl = codes per packed i32 lane (8 for 4-bit, 4 for 8-bit);
    lps = lanes per subspace (= R/cpl); slots[j] = (plane, lane_offset)
    of subspace j's packed words; cp = total planes per record.

    Plane 0 holds the R neighbour ids in lanes [0, r) and subspace words
    in its free tail; later planes are all words. No subspace ever
    crosses a plane boundary. The tail packing fits m=16 x ksub=256
    codes at R=48 in two planes (1 KB per node)."""
    cpl = 32 // bits                  # 8 for 4-bit, 4 for 8-bit
    if r % cpl:
        raise ValueError(f"R={r} must be a multiple of {cpl} for {bits}-bit")
    lps = r // cpl
    slots = []
    plane, off = 0, r
    for _ in range(m):
        if off + lps > 128:
            plane, off = plane + 1, 0
        slots.append((plane, off))
        off += lps
    return cpl, lps, slots, plane + 1


def _record_words(adj_rows, codes, r, m, bits):
    """[c, R] neighbour ids -> [c, m, lps] int32 code words. Packed in
    int64 and wrapped into int32: 8-bit codes at shift 24 set the sign
    bit by design, as the reference's two's-complement pack does."""
    cpl, lps, _, _ = pq_layout(r, m, bits)
    c = adj_rows.shape[0]
    nc = codes[adj_rows].to(torch.int64)                    # [c, R, m]
    nc = nc.permute(0, 2, 1).reshape(c, m, lps, cpl)
    shifts = torch.arange(cpl, device=nc.device) * bits
    words = (nc << shifts).sum(3)                           # [0, 2^32)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _assemble_record(adj_rows, words, r, m, bits):
    """[c, R] ids + [c, m, lps] words -> [c, CP, 128] per pq_layout
    (zeros in every lane no subspace takes)."""
    _, lps, slots, cp = pq_layout(r, m, bits)
    out = torch.zeros((adj_rows.shape[0], cp, LANES), dtype=torch.int32,
                      device=adj_rows.device)
    out[:, 0, :r] = adj_rows.to(torch.int32)
    for j, (pj, off) in enumerate(slots):
        out[:, pj, off : off + lps] = words[:, j, :]
    return out


def pack_pq_records(
    adjacency,                # [N+1, R] int (pad/sentinel = N)
    codes,                    # [N+1, m] uint8 (row N = zeros)
    bits: int,
    chunk: int = 262144,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Build records [N+1, CP, 128] int32 on `device`, byte-equal to the
    reference's `pack_pq_records`, in row chunks so the gathered codes
    stay ~chunk*R*m*8 bytes."""
    dev = resolve_device(device)
    adj = torch.as_tensor(np.asarray(adjacency, np.int64)).to(dev)
    codes_t = torch.as_tensor(np.asarray(codes, np.uint8)).to(dev)
    n1, r = adj.shape
    m = codes_t.shape[1]
    if r > LANES:
        raise ValueError("R <= 128 required")
    cp = pq_layout(r, m, bits)[3]
    out = torch.empty((n1, cp, LANES), dtype=torch.int32, device=dev)
    for i in range(0, n1, chunk):
        rows = adj[i : i + chunk]
        out[i : i + chunk] = _assemble_record(
            rows, _record_words(rows, codes_t, r, m, bits), r, m, bits)
    return out


def pack_pq_records_host(adjacency, codes, bits: int,
                         chunk: int = 262144) -> np.ndarray:
    """`pack_pq_records` on the host, as a numpy array."""
    return pack_pq_records(adjacency, codes, bits, chunk, "cpu").numpy()


def repack_pq_rows(
    records: torch.Tensor,    # [N+1, CP, 128] int32 (updated in place)
    adjacency: torch.Tensor,  # [N+1, R] int
    codes: torch.Tensor,      # [N+1, m] uint8
    rows: torch.Tensor,       # [K] int (pad = sentinel N)
    bits: int,
) -> torch.Tensor:
    """Refresh packed records after adjacency rows changed, in place
    (the reference donates the buffer to the same effect). Pad rows
    rewrite the sentinel row with its own content (all-sentinel ids,
    zero codes)."""
    r = adjacency.shape[1]
    m = codes.shape[1]
    rows = rows.to(torch.int64)
    adj_rows = adjacency[rows].to(torch.int64)
    records[rows] = _assemble_record(
        adj_rows, _record_words(adj_rows, codes, r, m, bits), r, m, bits)
    return records


# ------------------------------------------------------------ plain version


def _adc_scores(rec, lut, r, m, ksub, bits, slots):
    """ADC scores of every neighbour of the fetched records: rec [B, E,
    CP*128] int32, lut [B, m*ksub] f32 -> [B, E, R] f32, in the Pallas
    kernel's rounding. Narrow path (ksub <= 16): sum_j bf16(LUT[j, c_j])
    in float32, j = 0..m-1. Wide path: bf16(sum_j LUT[j, c_j]), the
    float32 sequential sum rounded once. A code >= ksub adds 0, as the
    reference's one-hot finds no match for it."""
    b, e, _ = rec.shape
    cpl = 32 // bits
    i = torch.arange(r, device=rec.device)
    word_in, shift = i // cpl, (i % cpl) * bits
    wide = ksub > 16
    if not wide:
        lut = lut.to(torch.bfloat16).float()
    acc = torch.zeros((b, e, r), dtype=torch.float32, device=rec.device)
    for j in range(m):
        pj, off = slots[j]
        code = (rec[:, :, pj * LANES + off + word_in] >> shift) & (
            (1 << bits) - 1)                                 # [B, E, R]
        idx = (j * ksub + code.clamp_max(ksub - 1)).reshape(b, e * r)
        val = torch.gather(lut, 1, idx.to(torch.int64)).reshape(b, e, r)
        acc = acc + torch.where(code < ksub, val, 0.0)
    return acc.to(torch.bfloat16).float() if wide else acc


def pq_beam_search_plain(
    luts, records, seed_ids, seed_scores, exclude, r, m, ksub, bits,
    beam_width, max_iters, expansions=2, qb=16, ring_size=1024,
    track_visited=0,
):
    """Plain PyTorch version of the PQ kernel, batched over queries, hop
    by hop as the Pallas kernel runs them. Queries run in groups of qb
    (the Pallas program): a query whose beam is fully expanded keeps
    taking empty merges while any query of its group is active, and
    those merges permute entries of equal score through the bitonic
    network. The visited log wraps: lanes (it*E + t) % VT take u_t on
    every hop up to max_iters, the sentinel once the query is inactive.
    Same arguments and outputs as `pq_beam_search`."""
    b = luts.shape[0]
    dev = luts.device
    n1, cp, _ = records.shape
    n_sentinel = n1 - 1
    e, l = expansions, beam_width
    s = seed_ids.shape[1]
    c, p2, v, vt = _sizes(l, e, ring_size, track_visited)
    _, _, slots, _ = pq_layout(r, m, bits)
    flat = records.reshape(n1, cp * LANES)

    st_sc = torch.full((b, p2), NEG_INF, dtype=torch.float32, device=dev)
    st_sc[:, :s] = seed_scores
    st_id = torch.full((b, p2), n_sentinel, dtype=torch.int64, device=dev)
    st_id[:, :s] = seed_ids.to(torch.int64)
    st_exp = torch.zeros((b, p2), dtype=torch.bool, device=dev)
    ring = torch.full((b, e, v), -1, dtype=torch.int64, device=dev)
    ring[:, :, :p2] = st_id[:, None, :]
    vlog = torch.full((b, vt), n_sentinel, dtype=torch.int64, device=dev)

    excl = exclude.to(torch.int64)[:, None, None]
    iota = torch.arange(p2, device=dev)[None, :]
    lane = torch.arange(LANES, device=dev)
    dup_lower = lane[None, :] < lane[:, None]                   # [i, j]: j < i
    pad = p2 - l - c

    for it in range(max_iters):
        pos, active = _first_k_unexpanded(st_sc, st_exp, e)     # [B, E]
        u = torch.where(active, torch.gather(st_id, 1, pos), n_sentinel)
        if vt:
            for t in range(e):
                vlog[:, (it * e + t) % vt] = u[:, t]
        alive = _group_any(active.any(1), qb)
        if not bool(alive.any()):
            if vt:  # the remaining hops only log the sentinel
                rest = torch.arange(e * (it + 1), e * max_iters,
                                    device=dev)[:vt] % vt
                vlog[:, rest] = n_sentinel
            break
        hit = torch.zeros_like(st_exp)
        for t in range(e):
            hit |= (iota == pos[:, t : t + 1]) & active[:, t : t + 1]
        st_exp = st_exp | hit

        rec = flat[u]                                           # [B, E, CP*128]
        nbr = torch.where(lane < r, rec[:, :, :LANES].to(torch.int64),
                          n_sentinel)                           # [B, E, 128]
        cand_sc = torch.nn.functional.pad(
            _adc_scores(rec, luts, r, m, ksub, bits, slots), (0, LANES - r))

        valid = (nbr != n_sentinel) & (nbr != excl)
        valid &= ~((nbr[..., :, None] == nbr[..., None, :]) & dup_lower).any(-1)
        if e == 2:
            cross = (nbr[:, 1, :, None] == nbr[:, 0, None, :]).any(-1)
            valid[:, 1] &= ~cross
        valid &= ~_member(nbr, st_id[:, None, :].expand(-1, e, -1))
        valid &= ~_member(nbr, ring)

        cand_sc = torch.where(valid, cand_sc, NEG_INF)
        cand_id = torch.where(valid, nbr, n_sentinel)
        new_ring = torch.cat([torch.where(valid, nbr, -1),
                              ring[:, :, : v - LANES]], dim=2)

        m_sc = torch.cat([st_sc[:, :l], cand_sc.reshape(b, c),
                          torch.full((b, pad), NEG_INF, device=dev)], 1)
        m_id = torch.cat([st_id[:, :l], cand_id.reshape(b, c),
                          torch.full((b, pad), n_sentinel, device=dev,
                                     dtype=torch.int64)], 1)
        m_exp = torch.cat([st_exp[:, :l],
                           torch.zeros((b, c + pad), dtype=torch.bool,
                                       device=dev)], 1)
        s_sc, s_id, s_exp = _bitonic_desc(m_sc, m_id, m_exp)
        live = iota < l
        a = alive[:, None]
        st_sc = torch.where(a, torch.where(live, s_sc, NEG_INF), st_sc)
        st_id = torch.where(a, torch.where(live, s_id, n_sentinel), st_id)
        st_exp = torch.where(a, torch.where(live, s_exp, True), st_exp)
        ring = torch.where(alive[:, None, None], new_ring, ring)

    out = (st_id[:, :l].to(torch.int32), st_sc[:, :l].contiguous())
    if vt:
        out = out + (vlog.to(torch.int32),)
    return out


# ------------------------------------------------------------- the kernel

MAX_SORT = 4096   # the CUDA kernel's largest sort width (P2)


def _check_inputs(luts, records, seed_ids, seed_scores, exclude, r, m, ksub,
                  bits, beam_width, expansions, qb):
    b = luts.shape[0]
    if bits not in (4, 8) or not 1 <= ksub <= 256:
        raise ValueError(f"bits in (4, 8) and ksub <= 256 (got {bits}, {ksub})")
    if not 1 <= r <= LANES or not 1 <= m <= 256:
        raise ValueError(f"PQ kernel needs R <= 128 and at most 256 code "
                         f"columns (got R={r}, m={m})")
    cp = pq_layout(r, m, bits)[3]
    if records.dim() != 3 or records.shape[1:] != (cp, LANES):
        raise ValueError(f"records must be [N+1, {cp}, 128] for R={r}, "
                         f"m={m}, {bits}-bit (pack_pq_records)")
    if luts.shape != (b, m * ksub):
        raise ValueError(f"luts must be [B, m*ksub] = [{b}, {m * ksub}]")
    if expansions not in (1, 2):
        raise ValueError("pq kernel supports expansions <= 2")
    if qb < 1:
        raise ValueError("qb >= 1")
    if seed_ids.dim() != 2 or seed_ids.shape[0] != b or \
            seed_scores.shape != seed_ids.shape or exclude.shape != (b,):
        raise ValueError("seed_ids/seed_scores [B, S] and exclude [B] expected")
    if seed_ids.shape[1] > beam_width:
        raise ValueError(f"seeds {seed_ids.shape[1]} > beam width {beam_width}")
    if records.shape[0] > 2**31 - 1:
        raise ValueError("node ids must fit int32")
    want = ((luts, torch.float32), (records, torch.int32),
            (seed_ids, torch.int32), (seed_scores, torch.float32),
            (exclude, torch.int32))
    for t, dt in want:
        if t.dtype != dt:
            raise TypeError(f"expected {dt}, got {t.dtype}")
        if t.device != luts.device:
            raise ValueError("all inputs must be on one device")


def pq_beam_search(
    luts: torch.Tensor,        # [B, m*ksub] f32 (metric folded in)
    records: torch.Tensor,     # [N+1, CP, 128] int32 (pack_pq_records)
    seed_ids: torch.Tensor,    # [B, S] int32
    seed_scores: torch.Tensor, # [B, S] f32 (must be ADC-comparable)
    exclude: torch.Tensor,     # [B] int32
    r: int,
    m: int,
    ksub: int,
    bits: int,
    beam_width: int,
    max_iters: int,
    expansions: int = 2,
    qb: int = 16,
    ring_size: int = 1024,
    track_visited: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Returns (beam_ids [B, L] int32, beam_scores [B, L] f32[, vlog
    [B, VT] int32]), VT = track_visited rounded up to a multiple of 128.
    Scores are ADC-approximate; callers must rescore exactly. Queries
    form groups of qb consecutive rows, as the reference's programs do.

    CUDA tensors launch the CUDA kernel; CPU tensors run
    `pq_beam_search_plain`."""
    _check_inputs(luts, records, seed_ids, seed_scores, exclude, r, m, ksub,
                  bits, beam_width, expansions, qb)
    if luts.device.type == "cpu":
        return pq_beam_search_plain(
            luts, records, seed_ids, seed_scores, exclude, r, m, ksub, bits,
            beam_width, max_iters, expansions, qb, ring_size, track_visited)
    if luts.device.type != "cuda":
        raise ValueError(f"unsupported device {luts.device}")

    from leann_tpu_torch.ops import _cuda

    lib = _cuda.load("pq_beam")
    b = luts.shape[0]
    cp = records.shape[1]
    e, l = expansions, beam_width
    s = seed_ids.shape[1]
    _, p2, v, vt = _sizes(l, e, ring_size, track_visited)
    _, _, slots, _ = pq_layout(r, m, bits)
    if p2 > MAX_SORT:
        raise ValueError(f"PQ kernel sorts at most {MAX_SORT} entries: "
                         f"beam_width + {e}*128 = {l + e * LANES}")
    smem = lib.leann_pq_beam_smem_bytes(m * ksub, cp, e, l, p2,
                                        (v + 3) & ~3, vt)
    if smem > 232448:
        raise ValueError(f"PQ kernel needs {smem} B of shared memory per "
                         "query (> 227 KB); lower m, ksub or ring_size")
    ts = [t.contiguous() for t in (luts, records, seed_ids, seed_scores,
                                   exclude)]
    if ts[1].data_ptr() % 16:
        raise ValueError("records must be 16-byte aligned (16-byte loads)")
    dev = luts.device
    out_ids = torch.empty((b, l), dtype=torch.int32, device=dev)
    out_sc = torch.empty((b, l), dtype=torch.float32, device=dev)
    vlog = torch.empty((b, max(vt, 1)), dtype=torch.int32, device=dev)
    hops = torch.empty((b,), dtype=torch.int32, device=dev)
    slot_words = (ctypes.c_int * m)(*(pj * LANES + off for pj, off in slots))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.leann_pq_beam_search(
            *(t.data_ptr() for t in ts), out_ids.data_ptr(),
            out_sc.data_ptr(), vlog.data_ptr() if vt else None,
            hops.data_ptr(), slot_words, b, r, m, ksub, bits, cp, s, l, e,
            p2, v, vt, max_iters, qb, records.shape[0] - 1, stream)
    _cuda.check(lib, err, "pq_beam_search")
    pq_beam_search.launches += 1
    return (out_ids, out_sc, vlog) if vt else (out_ids, out_sc)


pq_beam_search.launches = 0


def ctas_per_sm(m: int, ksub: int, cp: int, beam_width: int,
                expansions: int = 2, ring_size: int = 1024,
                track_visited: int = 0) -> int:
    """CTAs of the CUDA traversal kernel that fit on one SM at these
    sizes (its shared memory, registers and 256 threads), as the CUDA
    occupancy calculator gives them. Needs the card."""
    from leann_tpu_torch.ops import _cuda

    lib = _cuda.load("pq_beam")
    _, p2, v, vt = _sizes(beam_width, expansions, ring_size, track_visited)
    n = lib.leann_pq_beam_ctas_per_sm(m * ksub, cp, expansions, beam_width,
                                      p2, (v + 3) & ~3, vt)
    if n < 0:
        _cuda.check(lib, -n, "pq_beam ctas_per_sm")
    return n


# ------------------------------------------------------------- host engine


class PqBeamEngine:
    """Graph serving via the PQ fused kernel + exact candidate rescore.

    Construction: trains PQ codebooks on a corpus sample (or takes them),
    encodes the corpus, packs inline neighbour records. Search: ADC LUTs
    (a float32 GEMM) -> ADC-scored seeds -> fused traversal (beam +
    visited log) -> exact rescore of the union against the corpus (f32,
    bf16 or row-quantized int8 per `rescore`).
    """

    def __init__(
        self,
        vectors: np.ndarray,      # [N, D] f32
        adjacency: np.ndarray,    # [N(+1), R] int32
        medoid: int,
        metric: str = "ip",
        m: int = 16,
        ksub: int = 16,
        qb: int = 16,
        ring_size: int = 1024,
        visited_pool: int = 256,
        rescore: str = "f32",     # "f32" | "bf16" | "int8"
        train_sample: int = 262_144,
        kmeans_iters: int = 10,
        seed: int = 0,
        codebooks=None,           # [m,ksub,dsub] | (books_c, books_f)
        codes: Optional[np.ndarray] = None,
        coarse_m: int = 0,        # >0: residual (two-level) ADC mode
        rotation: Optional[np.ndarray] = None,  # [D, D] OPQ rotation
        device: DeviceLike = None,
    ):
        dev = self.device = resolve_device(device)
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.n, self.d = vectors.shape
        self.metric_in = metric
        if metric == "cosine":
            vectors = vectors / (
                np.linalg.norm(vectors, axis=1, keepdims=True) + 1e-12
            )
            metric = "ip"
        self.metric = metric
        self.m, self.ksub = m, ksub
        self.bits = 8 if ksub > 16 else 4
        if ksub > 256:
            raise ValueError("ksub <= 256")
        if rescore not in ("f32", "bf16", "int8"):
            raise ValueError(f"rescore must be f32, bf16 or int8 ({rescore!r})")
        self.qb = qb
        self.ring_size = ring_size
        self.visited_pool = visited_pool

        adj = np.ascontiguousarray(adjacency, dtype=np.int32)
        self.r = adj.shape[1]
        if adj.shape[0] == self.n:
            adj = np.concatenate(
                [adj, np.full((1, self.r), self.n, np.int32)]
            )

        # one rng for the training sample and then the seed pool, drawn
        # in the reference's order
        rng = np.random.default_rng(seed)

        # OPQ: train/encode in the rotated frame; the rotation folds into
        # lut_w below and |x_hat|^2 is rotation-invariant, so records,
        # kernel and the exact-rescore corpus (original frame) are
        # unchanged. `codebooks`/`codes` passed with a rotation must be
        # rotated-frame.
        self.rotation = None
        enc_vectors = vectors
        if rotation is not None:
            self.rotation = np.ascontiguousarray(rotation, np.float32)
            if self.rotation.shape != (self.d, self.d):
                raise ValueError("rotation must be [D, D]")
            enc_vectors = vectors @ self.rotation

        if coarse_m:
            # residual (two-level) mode: coarse-PQ + fine residual PQ +
            # (l2) quantized exact |x_hat|^2 as two affine-LUT columns
            if ksub != 256:
                raise ValueError("residual mode requires ksub=256")
            if codebooks is None:
                samp = enc_vectors[rng.choice(
                    self.n, min(train_sample, self.n), replace=False)]
                codebooks = train_residual_pq(
                    samp, mc=coarse_m, mf=m, ksub=ksub,
                    iters=kmeans_iters, seed=seed, device=dev)
            books_c, books_f = codebooks
            books_c = np.asarray(books_c, np.float32)
            books_f = np.asarray(books_f, np.float32)
            self.codebooks = (books_c, books_f)
            if codes is None:
                codes, nsq = encode_residual_pq(
                    enc_vectors, books_c, books_f, device=dev)
            else:
                codes = np.asarray(codes, np.uint8)
                xh = reconstruct_residual_pq(codes, books_c, books_f)
                nsq = np.einsum(
                    "nd,nd->n", xh, xh, dtype=np.float64
                ).astype(np.float32)
                del xh
            self.codes = np.asarray(codes, np.uint8)
            if metric == "l2":
                nq, n_off, n_scale = quantize_norms(nsq)
                codes_full = np.concatenate([self.codes, nq], axis=1)
                self.norm_offset, self.norm_scale = n_off, n_scale
            else:
                codes_full = self.codes
                self.norm_offset = self.norm_scale = 0.0
            self.mt = codes_full.shape[1]
            lut_w, lut_b = adc_affine(
                self.d, metric, books_c, books_f, ksub,
                self.norm_offset, self.norm_scale)
        else:
            if codebooks is None:
                samp = enc_vectors[rng.choice(
                    self.n, min(train_sample, self.n), replace=False)]
                codebooks = train_pq(
                    samp, m=m, ksub=ksub, iters=kmeans_iters, seed=seed,
                    device=dev)
            self.codebooks = np.asarray(codebooks, np.float32)
            if codes is None:
                codes = encode_pq(enc_vectors, self.codebooks, device=dev)
            self.codes = np.asarray(codes, np.uint8)
            codes_full = self.codes
            self.mt = m
            lut_w, lut_b = adc_affine(
                self.d, metric, None, self.codebooks, ksub)
        self.coarse_m = coarse_m
        codes1 = np.concatenate(
            [codes_full, np.zeros((1, self.mt), np.uint8)], axis=0)
        self.records = pack_pq_records(adj, codes1, self.bits, device=dev)
        # affine LUT operands: luts = q @ W^T + B (ops/pq.adc_affine);
        # with OPQ, luts = (q rot) W^T + B = q (W rot^T)^T + B: the
        # rotation folds into W so queries enter unrotated
        lut_w2 = lut_w.reshape(self.mt * ksub, self.d)
        if self.rotation is not None:
            lut_w2 = lut_w2 @ self.rotation.T
        self.lut_w = torch.from_numpy(np.ascontiguousarray(lut_w2)).to(dev)
        self.lut_b = torch.from_numpy(
            np.ascontiguousarray(lut_b.reshape(self.mt * ksub))).to(dev)

        # exact-rescore corpus (+ sentinel zero row), cast on the host;
        # int8 is row-quantized with the scale folded into the gather
        corpus1 = np.concatenate(
            [vectors, np.zeros((1, self.d), np.float32)], axis=0)
        self.corpus_scale = None
        if rescore == "bf16":
            self.corpus = torch.from_numpy(corpus1).to(dev).to(torch.bfloat16)
        elif rescore == "int8":
            scale = np.maximum(
                np.abs(corpus1).max(axis=1), 1e-12).astype(np.float32)
            q8 = np.clip(
                np.round(corpus1 / scale[:, None] * 127.0), -127, 127
            ).astype(np.int8)
            self.corpus = torch.from_numpy(q8).to(dev)
            self.corpus_scale = torch.from_numpy(scale / 127.0).to(dev)
        else:
            self.corpus = torch.from_numpy(corpus1).to(dev)
        self.corpus_nsq = torch.from_numpy(
            (corpus1.astype(np.float64) ** 2).sum(axis=1).astype(
                np.float32)).to(dev)

        # seed pool, scored by ADC too: the seeds' score space must match
        # the kernel's candidate scores
        pool = seed_pool_size(self.n)
        seeds = rng.choice(self.n, size=pool, replace=False)
        sid = np.unique(np.concatenate([[medoid], seeds])).astype(np.int32)
        self.seed_ids = torch.from_numpy(sid).to(dev)
        if coarse_m:
            seed_hat = reconstruct_residual_pq(
                self.codes[sid], books_c, books_f)
            if metric == "l2":
                # the quantized norm: the exact value the kernel's norm
                # LUT columns contribute for these nodes
                nq_s = codes_full[sid, -2:].astype(np.float64)
                seed_nsq = (self.norm_offset
                            + (nq_s[:, 0] * 256.0 + nq_s[:, 1])
                            * self.norm_scale).astype(np.float32)
            else:
                seed_nsq = np.zeros(len(sid), np.float32)
        else:
            seed_hat = reconstruct_pq(self.codes[sid], self.codebooks)
            seed_nsq = (seed_hat.astype(np.float64) ** 2).sum(1).astype(
                np.float32)
        if self.rotation is not None:
            # back to the original frame: <q, x_hat rot^T> = <q rot, x_hat>
            seed_hat = seed_hat @ self.rotation.T
        self.seed_vecs_hat = torch.from_numpy(
            np.ascontiguousarray(seed_hat, np.float32)).to(dev).to(
                torch.bfloat16)
        self.seed_hat_nsq = torch.from_numpy(seed_nsq).to(dev)

    def search(self, queries, k=10, beam_width=64, exclude=None,
               max_iters=None):
        q = np.asarray(queries)
        b = q.shape[0] if q.ndim > 1 else 1
        ids, scores = self.search_device(
            queries, k=k, beam_width=beam_width, exclude=exclude,
            max_iters=max_iters,
        )
        idx = ids[:b].cpu().numpy().astype(np.int64)
        sc = scores[:b].cpu().numpy()
        return np.where(idx == self.n, -1, idx), sc

    def search_device(self, queries, k=10, beam_width=64, exclude=None,
                      max_iters=None):
        """Device-out search: (ids, scores) on the device, [B_padded, k]
        (the batch is padded to a multiple of qb, as in the reference)."""
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        if self.metric_in == "cosine":
            q = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-12)
        bb = -(-b // self.qb) * self.qb
        if bb != b:
            q = np.concatenate([q, np.zeros((bb - b, self.d), np.float32)])
        exc = np.full((bb,), -1, dtype=np.int32)
        if exclude is not None:
            exc[:b] = np.asarray(exclude, dtype=np.int32)
        return self._search(
            torch.from_numpy(np.ascontiguousarray(q)).to(self.device),
            torch.from_numpy(exc).to(self.device), k, beam_width, max_iters)

    def search_many_device(self, qs, k=10, beam_width=64, max_iters=None):
        """[M, B, D] device batches -> (ids, scores) [M, B, k]. B must be
        a multiple of qb."""
        _, b, _ = qs.shape
        if b % self.qb:
            raise ValueError(f"B={b} must be a multiple of qb={self.qb}")
        exc = torch.full((b,), -1, dtype=torch.int32, device=self.device)
        outs = [self._search(q, exc, k, beam_width, max_iters) for q in qs]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    def kernel_args(self, queries, exclude, beam_width, max_iters=None):
        """The `pq_beam_search` arguments of one device batch: the ADC
        LUTs (float32 GEMM, q @ W^T + B), the 16 best seeds of the pool
        by ADC score (bf16 operands, float32 products and sums), and the
        engine's traversal settings."""
        luts = queries @ self.lut_w.T + self.lut_b[None, :]     # [B, mt*ksub]
        seed_dots = (queries.to(torch.bfloat16).float()
                     @ self.seed_vecs_hat.float().T)            # [B, pool]
        if self.metric == "l2":
            seed_scores = 2.0 * seed_dots - self.seed_hat_nsq[None, :]
        else:
            seed_scores = seed_dots
        s_eff = min(16, self.seed_ids.shape[0])
        entry_sc, best = torch.sort(seed_scores, dim=1, descending=True,
                                    stable=True)
        return dict(
            luts=luts.contiguous(), records=self.records,
            seed_ids=self.seed_ids[best[:, :s_eff]].contiguous(),
            seed_scores=entry_sc[:, :s_eff].contiguous(), exclude=exclude,
            r=self.r, m=self.mt, ksub=self.ksub, bits=self.bits,
            beam_width=beam_width,
            max_iters=max_iters or (4 * beam_width) // 2 + 32,
            expansions=2, qb=self.qb, ring_size=self.ring_size,
            track_visited=self.visited_pool)

    def _search(self, queries, exclude, k, beam_width, max_iters):
        """LUT build -> seed select (ADC space) -> PQ kernel -> exact
        rescore of the sort-deduped beam + visited log (the reference's
        `_pq_search_impl`)."""
        beam_ids, _, vlog = pq_beam_search(
            **self.kernel_args(queries, exclude, beam_width, max_iters))
        cand = _dedup_candidates(beam_ids.to(torch.int64),
                                 vlog.to(torch.int64), self.n)
        return _rescore(queries, self.corpus, self.corpus_nsq, cand, self.n,
                        self.metric, k, exclude=exclude,
                        row_scale=self.corpus_scale)
