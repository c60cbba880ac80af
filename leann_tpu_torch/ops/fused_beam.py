"""Fused whole-traversal beam search: one kernel launch per query batch
(port of `leann_tpu/ops/fused_beam.py`).

`fused_beam_search` runs the entire best-first loop of every query
inside one launch of the hand-written CUDA kernel `csrc/fused_beam.cu`
(one CTA per query, state in shared memory). On CPU tensors the same
wrapper runs `fused_beam_search_plain`, which follows the kernel's hop
semantics step by step in PyTorch (ring, sibling rule and bitonic merge
included); the tests hold it against the reference's Pallas kernel in
interpret mode, and `chip_smoke.py` holds the CUDA kernel against it.

Storage layout (built once by pack_fused(), byte-identical to the
reference's):
  blocks [N+1, R, D] int8   row-quantized neighbour vectors
  meta   [N+1, 3, 128] int32 planes: [0] neighbour ids (lane pad =
                             sentinel N), [1] dequant-scale bits,
                             [2] |v|^2 bits

The traversal scores candidates from int8; the engine rescores the
returned beam (plus the visited log) against the f32 corpus.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from leann_tpu_torch.device import DeviceLike, resolve_device
from leann_tpu_torch.ops import _cuda
from leann_tpu_torch.ops.beam import _rescore, _seed_entries, draw_seed_ids
from leann_tpu_torch.utils.trace import device_span, tracing

NEG_INF = float("-inf")
BIG = 2**30
LANES = 128  # lane-padded candidate width per expansion (RP); R <= 128


# ------------------------------------------------------------------ pack


def _row_sq_norms(vectors: torch.Tensor) -> torch.Tensor:
    """|v|^2 per row, summed in a fixed order: sequentially inside
    32-wide windows, then sequentially across windows. That is the order
    of XLA's CPU row reduction, so the packed |v|^2 bits equal the
    reference's, and the result is the same on either device (only
    elementwise float32 adds)."""
    sq = vectors * vectors
    n, d = sq.shape
    w = 32 if d % 32 == 0 else d
    sq = sq.reshape(n, d // w, w)
    acc = torch.zeros((n, d // w), dtype=torch.float32, device=sq.device)
    for i in range(w):
        acc = acc + sq[:, :, i]
    out = torch.zeros((n,), dtype=torch.float32, device=sq.device)
    for j in range(d // w):
        out = out + acc[:, j]
    return out


def quantize_corpus(
    vectors: torch.Tensor,  # [N+1, D] f32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-quantize: (q8 [N+1, D] int8, scale [N+1] f32, nsq [N+1] f32).
    Round half to even and an fp32 divide, as the reference does."""
    scale = torch.clamp_min(vectors.abs().amax(1), 1e-12) / 127.0
    q8 = torch.clamp(torch.round(vectors / scale[:, None]), -127, 127).to(
        torch.int8)
    return q8, scale, _row_sq_norms(vectors)


def _meta_rows(adj_rows, scale, nsq, n_sentinel):
    """[K, R] adjacency rows -> [K, 3, 128] int32 meta planes."""
    k, r = adj_rows.shape
    meta = torch.zeros((k, 3, LANES), dtype=torch.int32, device=adj_rows.device)
    meta[:, 0, :] = n_sentinel
    meta[:, 0, :r] = adj_rows.to(torch.int32)
    meta[:, 1, :r] = scale[adj_rows].view(torch.int32)
    meta[:, 2, :r] = nsq[adj_rows].view(torch.int32)
    return meta


def pack_fused(
    vectors: torch.Tensor,    # [N+1, D] f32 (sentinel row N = zeros)
    adjacency: torch.Tensor,  # [N+1, R] int (pad = N), R <= 128
    chunk: int = 131072,
    quant: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build (blocks [N+1, R, D] int8, meta [N+1, 3, 128] int32), in row
    chunks so the gather temporary stays ~chunk*R*D bytes."""
    n1, d = vectors.shape
    r = adjacency.shape[1]
    if r > LANES:
        raise ValueError(f"fused pack supports R <= 128 (got {r})")
    q8, scale, nsq = quant if quant is not None else quantize_corpus(vectors)
    adj = adjacency.to(torch.int64)
    blocks = torch.empty((n1, r, d), dtype=torch.int8, device=vectors.device)
    meta = torch.empty((n1, 3, LANES), dtype=torch.int32, device=vectors.device)
    for i in range(0, n1, chunk):
        rows = adj[i : i + chunk]
        blocks[i : i + chunk] = q8[rows]
        meta[i : i + chunk] = _meta_rows(rows, scale, nsq, n1 - 1)
    return blocks, meta


def repack_rows(
    blocks: torch.Tensor,     # [N+1, R, D] int8 (updated in place)
    meta: torch.Tensor,       # [N+1, 3, 128] int32 (updated in place)
    q8: torch.Tensor,         # [N+1, D] int8
    scale: torch.Tensor,      # [N+1] f32
    nsq: torch.Tensor,        # [N+1] f32
    adjacency: torch.Tensor,  # [N+1, R] int
    rows: torch.Tensor,       # [K] int, pad = sentinel N
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refresh the packed records of `rows` after their adjacency rows
    changed. In place (the reference donates the buffers to the same
    effect). Pad rows (= N) rewrite the sentinel row with its own
    content, so duplicate pad scatters are harmless."""
    rows = rows.to(torch.int64)
    adj_rows = adjacency[rows].to(torch.int64)
    blocks[rows] = q8[adj_rows]
    meta[rows] = _meta_rows(adj_rows, scale, nsq, blocks.shape[0] - 1)
    return blocks, meta


def fused_wave_search(
    queries: torch.Tensor,    # [B, D] f32
    vecs_dev: torch.Tensor,   # [N+1, D] f32 (for the medoid seed score)
    sq_norms: torch.Tensor,   # [N+1] f32
    blocks: torch.Tensor,
    meta: torch.Tensor,
    medoid: int,
    exclude: torch.Tensor,    # [B] (the point being inserted)
    r: int,
    beam_width: int,
    max_iters: int,
    metric: str,
    expansions: int = 2,
    track_visited: int = 160,
    qb: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Graph-builder wave search on the fused kernel: medoid entry,
    visited-set logging. Returns (beam_ids [B, L], vlog_ids [B, T])."""
    beam_ids, _, vlog = fused_beam_search(**wave_kernel_args(
        queries, vecs_dev, sq_norms, blocks, meta, medoid, exclude, r,
        beam_width, max_iters, metric, expansions, track_visited, qb))
    return beam_ids, vlog[:, :track_visited]


def wave_kernel_args(queries, vecs_dev, sq_norms, blocks, meta, medoid,
                     exclude, r, beam_width, max_iters, metric,
                     expansions=2, track_visited=160, qb=16) -> dict:
    """The `fused_beam_search` arguments of one build wave: the medoid is
    the one seed, scored in f32."""
    b = queries.shape[0]
    mv = vecs_dev[medoid]
    dots = queries @ mv
    seed_sc = 2.0 * dots - sq_norms[medoid] if metric == "l2" else dots
    seed_ids = torch.full((b, 1), int(medoid), dtype=torch.int32,
                          device=queries.device)
    return dict(queries=queries, blocks_i8=blocks, meta_i32=meta,
                seed_ids=seed_ids, seed_scores=seed_sc[:, None].contiguous(),
                exclude=exclude.to(torch.int32), r=r, beam_width=beam_width,
                max_iters=max_iters, metric=metric, expansions=expansions,
                qb=qb, track_visited=track_visited)


# ------------------------------------------------------------ plain version


def _bitonic_desc(sc, ids, exp):
    """Bitonic sort of [Q, P] rows (P a power of two), descending by
    score, carrying (ids, exp). The same network and tie rule as the
    reference's `_bitonic_desc` and the CUDA kernel: in descending blocks
    the lower position keeps the max, ties stay."""
    _, p = sc.shape
    idx = torch.arange(p, device=sc.device)
    k = 2
    while k <= p:
        j = k // 2
        while j >= 1:
            partner = idx ^ j
            ps, pi, pe = sc[:, partner], ids[:, partner], exp[:, partner]
            lower = (idx & j) == 0
            descending = (idx & k) == 0
            want_max = ~(descending ^ lower)
            self_bigger = (sc > ps) | ((sc == ps) & lower)
            keep = ~(want_max ^ self_bigger)
            sc = torch.where(keep, sc, ps)
            ids = torch.where(keep, ids, pi)
            exp = torch.where(keep, exp, pe)
            j //= 2
        k *= 2
    return sc, ids, exp


def _first_k_unexpanded(sc, exp, e):
    """Positions of the e first unexpanded live entries per row, and
    their active flags ([Q, e] each)."""
    _, p = sc.shape
    iota = torch.arange(p, device=sc.device)[None, :]
    poss, actives = [], []
    taken = torch.zeros_like(exp)
    for _ in range(e):
        mask = (~exp) & (~taken) & (sc > NEG_INF)
        pos = torch.where(mask, iota, BIG).amin(1)
        active = pos < BIG
        pos = torch.where(active, pos, 0)
        poss.append(pos)
        actives.append(active)
        taken = taken | (iota == pos[:, None])
    return torch.stack(poss, 1), torch.stack(actives, 1)


def _kernel_order_dots(rows_i8, q_bf):
    """[B, E, R, D] int8 rows . [B, D] bf16-valued query -> [B, E, R]
    float32, summed in the CUDA kernel's order: lane l of a warp adds
    elements 4l..4l+3 of each 128-wide slice in turn, then the 32 lane
    sums meet in a butterfly (xor 16, 8, 4, 2, 1). The products are exact
    in float32, so plain and kernel scores agree bit for bit."""
    b, e, r, d = rows_i8.shape
    prod = (rows_i8.float() * q_bf[:, None, None, :]).reshape(
        b, e, r, d // 128, 32, 4)
    acc = torch.zeros((b, e, r, 32), dtype=torch.float32,
                      device=rows_i8.device)
    for k in range(d // 128):
        for i in range(4):
            acc = acc + prod[..., k, :, i]
    for o in (16, 8, 4, 2, 1):
        acc = acc[..., :o] + acc[..., o : 2 * o]
    return acc[..., 0]


def _member(x, pool):
    """[..., K] -> bool: is x[..., k] anywhere in pool[..., :]? (sort +
    binary search; the same answer as an all-pairs compare)"""
    srt = torch.sort(pool, dim=-1).values.contiguous()
    pos = torch.searchsorted(srt, x.contiguous()).clamp_max(srt.shape[-1] - 1)
    return torch.gather(srt, -1, pos) == x


def _group_any(x, qb):
    """[B] bool -> [B] bool: is x true anywhere in b's group of qb
    consecutive queries (the Pallas kernel's program)?"""
    b = x.shape[0]
    pad = -b % qb
    xp = torch.cat([x, x.new_zeros(pad)]).reshape(-1, qb).any(1)
    return xp.repeat_interleave(qb)[:b]


def _needs_network(a_sc, a_id, a_exp, cand_sc, valid, n_sentinel):
    """[B] bool: the hops whose merge the CUDA kernel hands to the
    bitonic network. Its rank merge needs a beam whose live entries come
    first in strictly descending order, a tail of (-inf, sentinel,
    unexpanded) entries, admitted candidates with scores above -inf, and
    no two equal scores among the live entries of beam and candidates
    (-0.0 equals +0.0). Then the descending order is unique and any
    correct merge gives the network's output; otherwise the network's own
    permutation of the ties decides."""
    live = a_sc != NEG_INF
    unsorted = (live[:, 1:] & ~(a_sc[:, :-1] > a_sc[:, 1:])).any(1)
    bad_tail = (~live & ((a_id != n_sentinel) | a_exp)).any(1)
    bad_cand = (valid & ~(cand_sc > NEG_INF)).any(1)
    vals = torch.cat([torch.where(live, a_sc, NEG_INF),
                      torch.where(valid, cand_sc, NEG_INF)], 1)
    srt = torch.sort(vals, dim=1, descending=True).values
    dup = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != NEG_INF)).any(1)
    return unsorted | bad_tail | bad_cand | dup


def _sizes(l, e, ring_size, track_visited):
    c = e * LANES
    p2 = 1 << int(np.ceil(np.log2(l + c)))
    v = max(ring_size, p2)
    vt = -(-track_visited // 128) * 128 if track_visited else 0
    return c, p2, v, vt


def fused_beam_search_plain(
    queries, blocks_i8, meta_i32, seed_ids, seed_scores, exclude, r,
    beam_width, max_iters, metric, expansions=2, qb=16, ring_size=1024,
    track_visited=0, merge_stats=False, expansion_counts=False,
):
    """Plain PyTorch version of the fused kernel, batched over queries,
    hop by hop as the Pallas kernel runs them. Queries run in groups of
    qb (the Pallas program): a query with no unexpanded live entry keeps
    taking merges while any query of its group is active. Its candidates
    are all (-inf, sentinel) and its ring shifts in -1s, but the bitonic
    network permutes entries of equal score. Every merge is the bitonic
    network; with `merge_stats` it also counts, per query, the active
    hops and those that the CUDA kernel merges with the network
    (`_needs_network`); with `expansion_counts`, the nodes each query
    expanded. Same arguments and outputs as `fused_beam_search`."""
    del r
    b, _ = queries.shape
    dev = queries.device
    n_sentinel = blocks_i8.shape[0] - 1
    e, l = expansions, beam_width
    s = seed_ids.shape[1]
    c, p2, v, vt = _sizes(l, e, ring_size, track_visited)

    st_sc = torch.full((b, p2), NEG_INF, dtype=torch.float32, device=dev)
    st_sc[:, :s] = seed_scores
    st_id = torch.full((b, p2), n_sentinel, dtype=torch.int64, device=dev)
    st_id[:, :s] = seed_ids.to(torch.int64)
    st_exp = torch.zeros((b, p2), dtype=torch.bool, device=dev)
    ring = torch.full((b, e, v), -1, dtype=torch.int64, device=dev)
    ring[:, :, :p2] = st_id[:, None, :]
    vlog = torch.full((b, vt), n_sentinel, dtype=torch.int64, device=dev)

    q_bf = queries.to(torch.bfloat16).float()
    excl = exclude.to(torch.int64)[:, None, None]
    iota = torch.arange(p2, device=dev)[None, :]
    lane = torch.arange(LANES, device=dev)
    dup_lower = lane[None, :] < lane[:, None]                   # [i, j]: j < i
    pad = p2 - l - c
    slow = torch.zeros((b,), dtype=torch.int32, device=dev)
    hops = torch.zeros((b,), dtype=torch.int32, device=dev)
    expanded = torch.zeros((b,), dtype=torch.int32, device=dev)

    for it in range(max_iters):
        pos, active = _first_k_unexpanded(st_sc, st_exp, e)     # [B, E]
        alive = _group_any(active.any(1), qb)
        if not bool(alive.any()):
            break
        hit = torch.zeros_like(st_exp)
        for t in range(e):
            hit |= (iota == pos[:, t : t + 1]) & active[:, t : t + 1]
        st_exp = st_exp | hit
        expanded += active.sum(1, dtype=torch.int32)
        u = torch.where(active, torch.gather(st_id, 1, pos), n_sentinel)
        if vt:
            for t in range(e):
                if it * e + t < vt:
                    vlog[:, it * e + t] = u[:, t]

        nbr = meta_i32[u, 0, :].to(torch.int64)                 # [B, E, 128]
        scale = meta_i32[u, 1, :].contiguous().view(torch.float32)
        nsq = meta_i32[u, 2, :].contiguous().view(torch.float32)
        dots = _kernel_order_dots(blocks_i8[u], q_bf)
        dots = torch.nn.functional.pad(dots, (0, LANES - dots.shape[2]))
        cand_sc = dots * scale
        if metric == "l2":
            cand_sc = 2.0 * cand_sc - nsq

        valid = (nbr != n_sentinel) & (nbr != excl)
        valid &= ~((nbr[..., :, None] == nbr[..., None, :]) & dup_lower).any(-1)
        if e == 2:
            cross = (nbr[:, 1, :, None] == nbr[:, 0, None, :]).any(-1)
            valid[:, 1] &= ~cross
        valid &= ~_member(nbr, st_id[:, None, :].expand(-1, e, -1))
        valid &= ~_member(nbr, ring)

        if merge_stats:
            own = active.any(1)
            hops += own.to(torch.int32)
            slow += (own & _needs_network(
                st_sc[:, :l], st_id[:, :l], st_exp[:, :l],
                cand_sc.reshape(b, c), valid.reshape(b, c),
                n_sentinel)).to(torch.int32)
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
    if merge_stats:
        out = out + (slow, hops)
    if expansion_counts:
        out = out + (expanded,)
    return out


# ------------------------------------------------------------- the kernel


def _check_inputs(queries, blocks_i8, meta_i32, seed_ids, seed_scores,
                  exclude, r, beam_width, expansions, qb):
    b, d = queries.shape
    if blocks_i8.dim() != 3 or meta_i32.shape[1:] != (3, LANES) or \
            blocks_i8.shape[1:] != (r, d):
        raise ValueError("blocks/meta not in pack_fused 3D layout; repack")
    if d % 128 or r > LANES or r < 1:
        raise ValueError(f"fused kernel needs D % 128 == 0 and R <= 128 "
                         f"(got D={d}, R={r})")
    if expansions not in (1, 2):
        raise ValueError("fused kernel supports expansions <= 2")
    if qb < 1:
        raise ValueError("qb >= 1")
    if seed_ids.dim() != 2 or seed_ids.shape[0] != b or \
            seed_scores.shape != seed_ids.shape or exclude.shape != (b,):
        raise ValueError("seed_ids/seed_scores [B, S] and exclude [B] expected")
    if seed_ids.shape[1] > beam_width:
        raise ValueError(f"seeds {seed_ids.shape[1]} > beam width {beam_width}")
    if blocks_i8.shape[0] > 2**31 - 1:
        raise ValueError("node ids must fit int32")
    want = ((queries, torch.float32), (blocks_i8, torch.int8),
            (meta_i32, torch.int32), (seed_ids, torch.int32),
            (seed_scores, torch.float32), (exclude, torch.int32))
    for t, dt in want:
        if t.dtype != dt:
            raise TypeError(f"expected {dt}, got {t.dtype}")
        if t.device != queries.device:
            raise ValueError("all inputs must be on one device")


def fused_beam_search(
    queries: torch.Tensor,     # [B, D] f32, D % 128 == 0
    blocks_i8: torch.Tensor,   # [N+1, R, D] int8 (pack_fused)
    meta_i32: torch.Tensor,    # [N+1, 3, 128] int32 (pack_fused)
    seed_ids: torch.Tensor,    # [B, S] int32 per-query entry nodes (desc)
    seed_scores: torch.Tensor, # [B, S] f32 their traversal scores
    exclude: torch.Tensor,     # [B] int32
    r: int,
    beam_width: int,
    max_iters: int,
    metric: str,
    expansions: int = 2,
    qb: int = 16,
    ring_size: int = 1024,
    track_visited: int = 0,
    merge_stats: bool = False,
    expansion_counts: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Returns (beam_ids [B, L] int32 desc, beam_scores [B, L] f32),
    int8-scored; with track_visited > 0 also vlog_ids [B, VT] int32
    (VT = track_visited rounded up to a multiple of 128): the first
    VT/E hops' expanded node ids, sentinel-padded; with merge_stats also
    (slow_merges [B] int32, hops [B] int32): each query's active hops and
    how many of them the kernel merged with the bitonic network because
    scores tied (the others by rank, with the same result); with
    expansion_counts, last, expanded [B] int32: the nodes each query
    expanded (the non-sentinel entries of a full visited log).

    While tracing is on (`utils.trace.tracing`), each call adds its
    expansions to the device-side int64 total
    `fused_beam_search.expansions` and its rows to
    `fused_beam_search.traced_queries`, under the launch counter's lock
    and with no sync.

    Queries form groups of qb consecutive rows, as the reference's
    programs do (B need not be a multiple of qb: the last group is
    short). CUDA tensors launch the CUDA kernel (one CTA per query, then
    the settle pass that replays the group's empty merges); CPU tensors
    run `fused_beam_search_plain`."""
    _check_inputs(queries, blocks_i8, meta_i32, seed_ids, seed_scores,
                  exclude, r, beam_width, expansions, qb)
    traced = tracing()
    if queries.device.type == "cpu":
        out = fused_beam_search_plain(
            queries, blocks_i8, meta_i32, seed_ids, seed_scores, exclude,
            r, beam_width, max_iters, metric, expansions, qb, ring_size,
            track_visited, merge_stats, expansion_counts or traced)
        if traced:
            _cuda.count_work(fused_beam_search, **_traced(out[-1]))
            if not expansion_counts:
                out = out[:-1]
        return out
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")

    lib = _cuda.load("fused_beam")
    b, d = queries.shape
    e, l = expansions, beam_width
    s = seed_ids.shape[1]
    _, p2, v, vt = _sizes(l, e, ring_size, track_visited)
    smem = lib.leann_fused_beam_smem_bytes(d, r, e, l, p2, (v + 3) & ~3)
    if smem > 232448:
        raise ValueError(f"fused kernel needs {smem} B of shared memory "
                         "per query (> 227 KB); lower R, D or ring_size")
    ts = [t.contiguous() for t in (queries, blocks_i8, meta_i32, seed_ids,
                                   seed_scores, exclude)]
    dev = queries.device
    out_ids = torch.empty((b, l), dtype=torch.int32, device=dev)
    out_sc = torch.empty((b, l), dtype=torch.float32, device=dev)
    vlog = torch.empty((b, max(vt, 1)), dtype=torch.int32, device=dev)
    hops, slow, expanded = torch.empty((3, b), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.leann_fused_beam_search(
            *(t.data_ptr() for t in ts), out_ids.data_ptr(),
            out_sc.data_ptr(), vlog.data_ptr() if vt else None,
            hops.data_ptr(), slow.data_ptr(), expanded.data_ptr(), b, d, r,
            s, l, e, p2, v, vt, max_iters, int(metric == "l2"),
            blocks_i8.shape[0] - 1, qb, stream)
    _cuda.check(lib, err, "fused_beam_search")
    _cuda.count_launch(fused_beam_search,
                       **(_traced(expanded) if traced else {}))
    out = (out_ids, out_sc, vlog) if vt else (out_ids, out_sc)
    if merge_stats:
        out = out + (slow, hops)
    return out + (expanded,) if expansion_counts else out


def _traced(expanded: torch.Tensor) -> dict:
    """What one traced call adds to the wrapper's totals: its expansions,
    summed on the device, and its rows."""
    return {"expansions": expanded.sum(dtype=torch.int64),
            "traced_queries": expanded.shape[0]}


fused_beam_search.launches = 0
fused_beam_search.expansions = 0
fused_beam_search.traced_queries = 0


def ctas_per_sm(d: int, r: int, beam_width: int, expansions: int = 2,
                ring_size: int = 1024, track_visited: int = 0) -> int:
    """CTAs of the CUDA traversal kernel that fit on one SM at these
    sizes (its shared memory, registers and 256 threads), as the CUDA
    occupancy calculator gives them. Needs the card."""
    lib = _cuda.load("fused_beam")
    _, p2, v, _ = _sizes(beam_width, expansions, ring_size, track_visited)
    n = lib.leann_fused_beam_ctas_per_sm(d, r, expansions, beam_width, p2,
                                         (v + 3) & ~3)
    if n < 0:
        _cuda.check(lib, -n, "fused_beam ctas_per_sm")
    return n


# ------------------------------------------------------------- host engine


def _dedup_candidates(beam_ids, vlog_ids, n_sentinel):
    """beam [B, L] ++ visited log [B, VT] -> sorted candidates with
    repeats set to the sentinel. Visited entries duplicate beam entries;
    a sort-dedup is O(C log C), and the order after the rescore comes
    from the scores anyway."""
    cand, _ = torch.sort(torch.cat([beam_ids, vlog_ids], dim=1), dim=1)
    dup = torch.cat([torch.zeros_like(cand[:, :1], dtype=torch.bool),
                     cand[:, 1:] == cand[:, :-1]], dim=1)
    return torch.where(dup, n_sentinel, cand)


def state_from_reference(
    vectors: np.ndarray,     # [N, D] f32 corpus
    adjacency: np.ndarray,   # [N, R] int32, pad = N
    medoid: int,
    seed: int = 0,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """The reference's numpy index arrays -> the port's device tensors:
    corpus with its zero sentinel row, |v|^2, the packed blocks/meta
    (byte-identical to the reference's pack_fused) and the seed pool."""
    dev = resolve_device(device)
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    adj = np.ascontiguousarray(adjacency, dtype=np.int32)
    if adj.shape[0] == n:
        adj = np.concatenate([adj, np.full((1, adj.shape[1]), n, np.int32)])
    corpus = torch.from_numpy(
        np.concatenate([vectors, np.zeros((1, d), np.float32)])).to(dev)
    blocks, meta = pack_fused(corpus, torch.from_numpy(adj).to(dev))
    seed_ids = torch.from_numpy(
        draw_seed_ids(n, medoid, seed).astype(np.int64)).to(dev)
    return {
        "corpus": corpus,
        "sq_norms": (corpus * corpus).sum(1),
        "blocks": blocks,
        "meta": meta,
        "seed_ids": seed_ids,
        "seed_vecs": corpus[seed_ids].to(torch.bfloat16),
        "medoid": torch.tensor(int(medoid), device=dev),
    }


class FusedBeamEngine:
    """Host-facing wrapper around the fused whole-traversal kernel:
    query-adaptive seed selection (one matmul over a resident seed pool),
    the fused traversal, then the exact f32 rescore of the final beam and
    the visited log."""

    def __init__(
        self,
        vectors: np.ndarray,
        adjacency: np.ndarray,
        medoid: int,
        metric: str = "ip",
        expansions: int = 2,
        qb: int = 16,
        ring_size: int = 1024,
        visited_pool: int = 128,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.visited_pool = int(
            os.environ.get("LEANN_FUSED_VISITED", visited_pool))
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.n, self.d = vectors.shape
        if self.d % 128 != 0:
            raise ValueError(
                f"fused kernel needs D % 128 == 0 (got {self.d}); "
                "use BeamSearchEngine for other dims"
            )
        self.metric_in = metric
        if metric == "cosine":
            vectors = vectors / (
                np.linalg.norm(vectors, axis=1, keepdims=True) + 1e-12
            )
            metric = "ip"
        self.metric = metric
        self.expansions = expansions
        self.qb = qb
        self.ring_size = ring_size
        self.r = np.asarray(adjacency).shape[1]
        self.medoid = int(medoid)
        st = state_from_reference(vectors, adjacency, medoid, seed,
                                  self.device)
        self.vectors, self.sq_norms = st["corpus"], st["sq_norms"]
        self.blocks, self.meta = st["blocks"], st["meta"]
        self.seed_ids, self.seed_vecs = st["seed_ids"], st["seed_vecs"]

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
        ids, scores = self._search(
            torch.from_numpy(np.ascontiguousarray(q)).to(self.device),
            torch.from_numpy(exc).to(self.device), beam_width, max_iters)
        return ids[:, :k], scores[:, :k]

    def search_many_device(self, qs, k=10, beam_width=64, max_iters=None):
        """[M, B, D] device-resident query batches -> (ids, scores) each
        [M, B, k]. B must be a multiple of qb."""
        m, b, d = qs.shape
        if b % self.qb:
            raise ValueError(f"B={b} must be a multiple of qb={self.qb}")
        with device_span("fused_beam.search_many"):
            exc = torch.full((b,), -1, dtype=torch.int32, device=self.device)
            outs = [self._search(q, exc, beam_width, max_iters) for q in qs]
            return (torch.stack([o[0][:, :k] for o in outs]),
                    torch.stack([o[1][:, :k] for o in outs]))

    def kernel_args(self, queries, exclude, beam_width, max_iters=None):
        """The `fused_beam_search` arguments of one device batch: the
        query-adaptive seeds (bf16 matmul over the seed pool) and the
        engine's traversal settings."""
        n_entries = min(16, max(1, beam_width // 2))
        mi = max_iters or (4 * beam_width) // self.expansions + 32
        entry_sc, entry = _seed_entries(
            queries.to(torch.bfloat16).float(), self.seed_vecs,
            self.seed_ids, self.sq_norms, self.metric, n_entries)
        return dict(queries=queries, blocks_i8=self.blocks,
                    meta_i32=self.meta, seed_ids=entry.to(torch.int32),
                    seed_scores=entry_sc.contiguous(), exclude=exclude,
                    r=self.r, beam_width=beam_width, max_iters=mi,
                    metric=self.metric, expansions=self.expansions,
                    qb=self.qb, ring_size=self.ring_size,
                    track_visited=self.visited_pool)

    def _search(self, queries, exclude, beam_width, max_iters):
        """Seed-select -> fused traversal -> exact f32 rescore of the
        beam plus the sort-deduped visited log (the reference's
        `_fused_search_jit`), each phase in a device span of its own."""
        with device_span("fused_beam.seeds"):
            kw = self.kernel_args(queries, exclude, beam_width, max_iters)
        with device_span("fused_beam.b1"):
            outs = fused_beam_search(**kw)
        with device_span("fused_beam.dedup"):
            beam_ids = outs[0].to(torch.int64)
            if self.visited_pool:
                cand = _dedup_candidates(beam_ids, outs[2].to(torch.int64),
                                         self.n)
            else:
                cand = beam_ids
        # excluded ids can enter through the seed pool: the rescore
        # drops them
        with device_span("fused_beam.rescore"):
            return _rescore(queries, self.vectors, self.sq_norms, cand,
                            self.n, self.metric, beam_ids.shape[1],
                            exclude=exclude)
