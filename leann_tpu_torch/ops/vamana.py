"""Batched Vamana graph construction (port of `leann_tpu/ops/vamana.py`).

Wave-parallel insertion: W points per wave search the current graph
together, a batched robust prune selects each point's R out-neighbours,
and reverse edges are resolved wave-synchronously.

Algorithm (two passes, alpha schedule [1.0, alpha], DiskANN-style):
  for each wave of W points p:
    1. search the current graph for p's vector (excluding p), logging
       the visited set -> candidate pool = visited ++ beam ++ N(p)
    2. robust prune: greedily keep the closest alive candidate c, then
       occlude every j with alpha * d(c, j) <= d(p, j)  -> N(p), |N(p)|<=R
    3. scatter N(p) rows into the adjacency
    4. reverse edges: group (q <- p) by q host-side, cap incoming per q
       per wave, then batched robust prune of [old N(q) ++ incoming]

Two wave-search engines: the fused CUDA traversal (`ops/fused_beam.py`,
on its plain version for CPU tensors) and the row-gather beam search
(`ops/beam.py`). Prune geometry is squared L2 on the (cosine:
pre-normalized) vectors, computed in float32.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Tuple

import numpy as np
import torch

from leann_tpu_torch.device import DeviceLike, free_device_bytes, resolve_device
from leann_tpu_torch.ops.beam import beam_search_batch

INF = float("inf")


class BuildAborted(RuntimeError):
    """Raised by the LEANN_BUILD_ABORT_AFTER test hook."""


def robust_prune_batch(
    point_vecs: torch.Tensor,   # [W, D]
    cand_ids: torch.Tensor,     # [W, C] int, sentinel = invalid
    cand_vecs: torch.Tensor,    # [W, C, D]
    sentinel: int,
    alpha: float,
    degree: int,
    precision: str = "highest",
) -> torch.Tensor:
    """Returns [W, degree] pruned neighbour ids (sentinel-padded), int64.

    `precision` is kept for the reference's signature; the port computes
    the pairwise distances in full float32 either way (the reference's
    "default" is bf16 on a TPU and float32 on a CPU)."""
    del precision
    w, c, _ = cand_vecs.shape
    dev = cand_vecs.device
    cand_ids = cand_ids.to(torch.int64)

    def sqdist(a, b):
        dots = torch.bmm(a, b.transpose(1, 2))
        na = (a * a).sum(-1)
        nb = (b * b).sum(-1)
        return torch.clamp_min(na[:, :, None] - 2.0 * dots + nb[:, None, :], 0.0)

    d_pc = sqdist(point_vecs[:, None, :], cand_vecs)[:, 0, :]       # [W, C]
    d_cc = sqdist(cand_vecs, cand_vecs)                             # [W, C, C]

    valid = cand_ids != sentinel
    # dedup identical ids within a row (keep the first valid occurrence)
    lower = (torch.arange(c, device=dev)[None, :]
             < torch.arange(c, device=dev)[:, None])
    dup = (cand_ids[:, :, None] == cand_ids[:, None, :]) & lower[None]
    valid &= ~(dup & valid[:, None, :]).any(2)
    d_pc = torch.where(valid, d_pc, INF)

    rows = torch.arange(w, device=dev)
    result = torch.full((w, degree), sentinel, dtype=torch.int64, device=dev)
    alive = valid
    for i in range(degree):
        masked = torch.where(alive, d_pc, INF)
        pick = torch.argmin(masked, dim=1)                          # [W]
        has = alive.any(1)
        result[:, i] = torch.where(has, cand_ids[rows, pick], sentinel)
        d_pick = d_cc[rows, pick]                                   # [W, C]
        alive = alive & ~(alpha * d_pick <= d_pc)
        alive[rows, pick] = False
        alive &= has[:, None]
    return result


def _pad_pow2(x: int, floor: int = 8) -> int:
    size = floor
    while size < x:
        size *= 2
    return size


def _write_ckpt(path, key, pass_i, next_start, adjacency_dev, n):
    """Atomic adjacency snapshot (temp file + rename)."""
    adj_host = adjacency_dev[:n].cpu().numpy().astype(np.int32)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, key=key, pass_i=np.int64(pass_i),
                 next_start=np.int64(next_start), adjacency=adj_host)
    os.replace(tmp, path)


# Wave-progress watchdog shared by every pass of a build: exits the
# process (code 17) if no wave completes for LEANN_BUILD_STALL_S seconds,
# so an outer retry loop can resume from the wave checkpoint. The
# threshold is re-read on every arm, and every build or insertion
# disarms it in a `finally`.
_WATCHDOG = {"thread": None, "active": False, "t": 0.0, "stall_s": 0.0}


def _arm_watchdog(stall_s: float):
    _WATCHDOG["stall_s"] = float(stall_s)
    _WATCHDOG["t"] = time.time()
    _WATCHDOG["active"] = True
    if _WATCHDOG["thread"] is not None:
        return

    def _watch():
        while True:
            time.sleep(min(30.0, max(_WATCHDOG["stall_s"], 0.4) / 4))
            stall = _WATCHDOG["stall_s"]
            if not _WATCHDOG["active"] or stall <= 0:
                continue
            if time.time() - _WATCHDOG["t"] > stall:
                print(f"[vamana] WATCHDOG: no wave progress in "
                      f"{stall:.0f}s — exiting 17 for resume",
                      file=sys.stderr, flush=True)
                os._exit(17)

    _WATCHDOG["thread"] = threading.Thread(target=_watch, daemon=True)
    _WATCHDOG["thread"].start()


def _heartbeat():
    _WATCHDOG["t"] = time.time()


def _disarm_watchdog():
    _WATCHDOG["active"] = False


def _stall_s() -> float:
    return float(os.environ.get("LEANN_BUILD_STALL_S", "0") or 0)


def build_vamana(
    vectors: np.ndarray,
    graph_degree: int = 32,
    complexity: int = 64,
    alpha: float = 1.2,
    metric: str = "ip",
    wave_size: int = 8192,
    incoming_cap: int = 8,
    passes: int = 2,
    seed: int = 0,
    verbose: bool = False,
    expansions: int = 2,
    checkpoint_path: str = None,
    checkpoint_every: int = 300,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, int]:
    """Returns (adjacency [N, R] int32 sentinel=N padded, medoid).

    checkpoint_path: optional .npz the builder snapshots the adjacency to
    every `checkpoint_every` waves (atomic rename); re-running with the
    same arguments and path resumes from it. The numpy rng stream is
    replayed, so the wave permutations are the same; a snapshot whose
    config key differs is ignored."""
    dev = resolve_device(device)
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    r = graph_degree
    if n <= 1:
        return np.full((n, r), n, dtype=np.int32), 0
    L = max(complexity, r + 1)
    rng = np.random.default_rng(seed)

    if metric == "cosine":
        vectors = vectors / (np.linalg.norm(vectors, axis=1, keepdims=True) + 1e-12)
        search_metric = "ip"
    else:
        search_metric = metric

    stall_s = _stall_s()
    if stall_s > 0:
        _arm_watchdog(stall_s)
    try:
        t_up = time.time()
        vecs_dev = torch.from_numpy(
            np.concatenate([vectors, np.zeros((1, d), np.float32)])).to(dev)
        sq_norms = (vecs_dev * vecs_dev).sum(1)
        _heartbeat()
        if verbose:
            print(f"[vamana] corpus upload+norms {time.time() - t_up:.1f}s",
                  file=sys.stderr, flush=True)

        # medoid: nearest (L2) to the centroid
        mean_dev = vecs_dev.sum(0) / n
        neg_d2 = 2.0 * (vecs_dev @ mean_dev) - sq_norms
        neg_d2[n] = -INF
        medoid = int(torch.argmax(neg_d2))
        _heartbeat()

        # random initial R-regular graph (self-edges displaced by +1)
        init = rng.integers(0, n - 1, size=(n, r), dtype=np.int64)
        init = np.where(init >= np.arange(n)[:, None], init + 1, init)
        adjacency = torch.from_numpy(np.concatenate(
            [init, np.full((1, r), n, np.int64)])).to(dev)       # [N+1, R]

        max_iters = 2 * L + 16

        # adaptive wave size: the prune materializes cand_vecs [W, C, D]
        # and the pairwise cube [W, C, C] with C = 3L + R; halve the wave
        # until that transient fits ~5 GB
        cand_width = 3 * L + r
        per_point = cand_width * d * 4 + cand_width * cand_width * 4
        while wave_size > 1024 and wave_size * per_point > 5.0e9:
            wave_size //= 2
        if verbose and wave_size != 8192:
            print(f"[vamana] wave_size -> {wave_size} "
                  f"(prune transient {wave_size * per_point / 1e9:.1f}GB)",
                  file=sys.stderr, flush=True)

        alphas = [1.0] * (passes - 1) + [alpha] if passes > 1 else [alpha]
        # early passes build a scaffold the final full-L pass refines
        beams = [max(r + 8, (7 * L) // 10)] * (len(alphas) - 1) + [L]

        ckpt_key = (f"n{n}|d{d}|r{r}|L{L}|p{passes}|s{seed}|e{expansions}|"
                    f"c{incoming_cap}|w{wave_size}|m{search_metric}")
        resume_pass, resume_start = 0, 0
        if checkpoint_path and os.path.exists(checkpoint_path):
            try:
                with np.load(checkpoint_path) as z:
                    if str(z["key"]) == ckpt_key:
                        resume_pass = int(z["pass_i"])
                        resume_start = int(z["next_start"])
                        adjacency = torch.from_numpy(np.concatenate([
                            np.asarray(z["adjacency"], np.int64),
                            np.full((1, r), n, np.int64),
                        ])).to(dev)
                        if verbose:
                            print(f"[vamana] resume pass {resume_pass + 1} "
                                  f"wave {resume_start // wave_size + 1} "
                                  f"from {checkpoint_path}",
                                  file=sys.stderr, flush=True)
                    elif verbose:
                        print(f"[vamana] checkpoint key mismatch "
                              f"({z['key']} != {ckpt_key}); ignoring",
                              file=sys.stderr, flush=True)
            except Exception as exc:  # corrupt snapshot: rebuild
                print(f"[vamana] unreadable checkpoint {checkpoint_path}: "
                      f"{exc}; ignoring", file=sys.stderr, flush=True)

        for pass_i, (pass_alpha, pass_L) in enumerate(zip(alphas, beams)):
            # always draw the permutation so the rng stream is identical
            # across resumes
            order = rng.permutation(n)
            if pass_i < resume_pass:
                continue
            start0 = resume_start if pass_i == resume_pass else 0
            if start0 < len(order):
                adjacency = _insert_waves(
                    vectors, vecs_dev, sq_norms, adjacency, medoid, order,
                    beam_width=pass_L, graph_degree=r, alpha=pass_alpha,
                    metric=search_metric, wave_size=wave_size,
                    incoming_cap=incoming_cap, max_iters=max_iters,
                    expansions=expansions, verbose=verbose,
                    start0=start0, ckpt_path=checkpoint_path,
                    ckpt_every=checkpoint_every, ckpt_key=ckpt_key,
                    pass_i=pass_i,
                )
            if checkpoint_path and pass_i + 1 < len(alphas):
                _write_ckpt(checkpoint_path, ckpt_key, pass_i + 1, 0,
                            adjacency, n)
            if verbose:
                print(f"[vamana] pass {pass_i + 1}/{len(alphas)} done "
                      f"(alpha={pass_alpha})", file=sys.stderr)

        return adjacency[:n].cpu().numpy().astype(np.int32), medoid
    finally:
        _disarm_watchdog()


def insert_points(
    vectors: np.ndarray,
    adjacency: np.ndarray,
    medoid: int,
    new_ids: np.ndarray,
    graph_degree: int = 32,
    complexity: int = 64,
    alpha: float = 1.2,
    metric: str = "ip",
    wave_size: int = 8192,
    incoming_cap: int = 8,
    seed: int = 0,
    device: DeviceLike = None,
) -> np.ndarray:
    """Incremental insertion: `vectors` is the FULL corpus (old + new);
    `adjacency` is [N_total, R] with the new rows arbitrary (they get
    replaced). Runs one insertion pass over `new_ids` only."""
    dev = resolve_device(device)
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    if metric == "cosine":
        vectors = vectors / (np.linalg.norm(vectors, axis=1, keepdims=True) + 1e-12)
        search_metric = "ip"
    else:
        search_metric = metric
    L = max(complexity, graph_degree + 1)
    vecs_dev = torch.from_numpy(
        np.concatenate([vectors, np.zeros((1, d), np.float32)])).to(dev)
    sq_norms = (vecs_dev * vecs_dev).sum(1)
    adj = np.ascontiguousarray(adjacency, dtype=np.int64)
    adj_dev = torch.from_numpy(
        np.concatenate([adj, np.full((1, adj.shape[1]), n, np.int64)])).to(dev)
    order = np.random.default_rng(seed).permutation(np.asarray(new_ids))
    try:
        adj_dev = _insert_waves(
            vectors, vecs_dev, sq_norms, adj_dev, int(medoid), order,
            beam_width=L, graph_degree=graph_degree, alpha=alpha,
            metric=search_metric, wave_size=wave_size,
            incoming_cap=incoming_cap, max_iters=2 * L + 16, expansions=2,
        )
    finally:
        _disarm_watchdog()
    return adj_dev[:n].cpu().numpy().astype(np.int32)


def _use_fused_engine(dev, n, d, r, expansions, n_order) -> bool:
    """LEANN_BUILD_ENGINE=auto|fused|fused-interpret|<other>. auto picks
    the fused traversal on CUDA when the kernel takes the shapes (D % 128
    == 0, R <= 128, E <= 2), the int8 blocks fit, and the insertion is
    bulk (>= 16384 points: packing costs ~N). The thresholds are shares
    of the free device memory (9/16 for the blocks, 14.5/16 for the
    peak), the shares the reference takes of its own device.
    `fused-interpret` (the reference's
    hermetic test hook) selects the fused engine too; on CPU tensors it
    runs the kernel's plain version."""
    choice = os.environ.get("LEANN_BUILD_ENGINE", "auto")
    if choice in ("fused", "fused-interpret"):
        return True
    if choice != "auto" or dev.type != "cuda":
        return False
    free = free_device_bytes(dev)
    blocks_b = (n + 1) * r * d
    corpus_b = 4 * (n + 1) * d
    return (
        d % 128 == 0
        and r <= 128
        and expansions <= 2
        and blocks_b < free * (9.0 / 16.0)
        and 2 * blocks_b + corpus_b + free / 16.0 < free * (14.5 / 16.0)
        and n_order >= 16384
    )


def _insert_waves(
    vectors: np.ndarray,
    vecs_dev: torch.Tensor,
    sq_norms: torch.Tensor,
    adjacency: torch.Tensor,
    medoid: int,
    order: np.ndarray,
    beam_width: int,
    graph_degree: int,
    alpha: float,
    metric: str,
    wave_size: int,
    incoming_cap: int,
    max_iters: int,
    expansions: int = 2,
    verbose: bool = False,
    start0: int = 0,
    ckpt_path: str = None,
    ckpt_every: int = 0,
    ckpt_key: str = "",
    pass_i: int = 0,
) -> torch.Tensor:
    dev = vecs_dev.device
    profile = bool(os.environ.get("LEANN_BUILD_PROFILE"))
    stall_s = _stall_s()
    if stall_s > 0:
        _arm_watchdog(stall_s)
    # test/ops hook: raise after K waves of this call
    abort_after = int(os.environ.get("LEANN_BUILD_ABORT_AFTER", "0") or 0)
    waves_done = 0
    n_waves = -(-len(order) // wave_size)
    pass_t0 = time.time()
    n = vecs_dev.shape[0] - 1
    d = vecs_dev.shape[1]
    r = graph_degree

    use_fused = _use_fused_engine(dev, n, d, r, expansions, len(order))
    if use_fused:
        from leann_tpu_torch.ops.fused_beam import (
            fused_wave_search, pack_fused, quantize_corpus, repack_rows,
        )

        t_pack = time.time()
        q8, scale, nsq = quantize_corpus(vecs_dev)
        blocks, meta = pack_fused(vecs_dev, adjacency, quant=(q8, scale, nsq))
        if verbose or profile:
            _sync(dev)
            print(f"[vamana] pack {time.time() - t_pack:.1f}s",
                  file=sys.stderr, flush=True)

    # Reverse edges of wave i are applied after wave i+1's forward step
    # (one wave late), as in the reference's software pipeline: the host
    # groups wave i's rows while the device works on wave i+1.
    track = 2 * beam_width
    pending = None  # (new rows on device [w, R], wave ids [w])

    def apply_pending(pend):
        nonlocal adjacency
        nb_dev, wave_prev = pend
        nb_host = nb_dev.cpu().numpy()
        src = np.repeat(wave_prev.astype(np.int64), r)
        dst = nb_host.reshape(-1)
        keep = dst != n
        src, dst = src[keep], dst[keep]
        if not dst.size:
            return
        adjacency, uniq_dst = _apply_reverse_edges(
            adjacency, vecs_dev, dst, src, n, r, incoming_cap, alpha)
        if use_fused:
            repack_rows(blocks, meta, q8, scale, nsq, adjacency,
                        torch.from_numpy(uniq_dst).to(dev))

    for start in range(start0, len(order), wave_size):
        t0 = time.time()
        wave = order[start : start + wave_size]
        w = len(wave)
        # constant wave shape across waves; only a corpus smaller than
        # wave_size gets a smaller pow-2 bucket
        wb = wave_size if len(order) > wave_size else _pad_pow2(w, 64)
        wave_pad = np.concatenate(
            [wave, np.zeros(wb - w, dtype=np.int64)]).astype(np.int64)
        wave_dev = torch.from_numpy(wave_pad).to(dev)
        q = vecs_dev[wave_dev]                                     # [wb, D]

        if use_fused:
            # Vamana prunes over the search's visited set (the early, far
            # expansions become the long-range edges)
            beam_ids, vlog_ids = fused_wave_search(
                q, vecs_dev, sq_norms, blocks, meta, medoid, wave_dev,
                r=r, beam_width=beam_width, max_iters=max_iters,
                metric=metric, expansions=expansions, track_visited=track,
            )
        else:
            beam_ids, _, vlog_ids, _ = beam_search_batch(
                q, vecs_dev, adjacency, sq_norms, medoid, wave_dev,
                beam_width=beam_width,
                # the cap must not shrink with E (hard distributions
                # lose candidate quality)
                max_iters=max_iters, metric=metric, expansions=expansions,
                precision="default", track_visited=track,
            )
        if profile:
            _sync(dev)
            t1 = time.time()
        # candidate pool: visited set ++ beam ++ current neighbours of p
        cur = adjacency[wave_dev]                                  # [wb, R]
        cand_ids = torch.cat([vlog_ids.to(torch.int64),
                              beam_ids.to(torch.int64), cur], dim=1)
        # self can appear via current-neighbour lists: mask it
        cand_ids = torch.where(cand_ids == wave_dev[:, None], n, cand_ids)
        new_nbrs = robust_prune_batch(
            q, cand_ids, vecs_dev[cand_ids], n, alpha, r,
            precision="default",
        )
        adjacency[wave_dev[:w]] = new_nbrs[:w]
        nb_dev = new_nbrs[:w]
        if use_fused:
            # forward rows must be fresh in the packed records before the
            # next wave's search
            repack_rows(blocks, meta, q8, scale, nsq, adjacency, wave_dev[:w])
        if profile:
            _sync(dev)
            t2 = time.time()

        if pending is not None:
            apply_pending(pending)
        pending = (nb_dev, wave[:w])
        if profile:
            _sync(dev)
            t3 = time.time()
            print(f"[wave {start // wave_size}] search {t1 - t0:.2f}s  "
                  f"prune+scatter {t2 - t1:.2f}s  reverse(prev) {t3 - t2:.2f}s"
                  f"  total {t3 - t0:.2f}s", file=sys.stderr, flush=True)
        elif verbose:
            wave_i = start // wave_size + 1
            if wave_i % 50 == 0 or wave_i == n_waves:
                el = time.time() - pass_t0
                done_here = wave_i - start0 // wave_size
                print(f"[vamana] wave {wave_i}/{n_waves}  {el:.0f}s elapsed  "
                      f"eta {el / done_here * (n_waves - wave_i):.0f}s",
                      file=sys.stderr, flush=True)
        _heartbeat()
        waves_done += 1
        wave_i = start // wave_size + 1
        if (ckpt_path and ckpt_every and wave_i % ckpt_every == 0
                and wave_i < n_waves):
            # adjacency holds all forward rows <= this wave and reverse
            # edges <= the previous wave; next_start skips this wave
            _write_ckpt(ckpt_path, ckpt_key, pass_i, start + wave_size,
                        adjacency, n)
            _heartbeat()
        if abort_after and waves_done >= abort_after:
            raise BuildAborted(f"LEANN_BUILD_ABORT_AFTER={abort_after}")
    if pending is not None:
        apply_pending(pending)
    if verbose or profile:
        print(f"[vamana] pass wall {time.time() - pass_t0:.1f}s",
              file=sys.stderr, flush=True)
    return adjacency


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


REVERSE_BLOCK = 32768  # rows per reverse-prune block


def _reverse_prune_block(
    adjacency: torch.Tensor,  # [N+1, R] (updated in place)
    vecs_dev: torch.Tensor,
    uniq: torch.Tensor,       # [A] int64, pad = n (sentinel)
    inc: torch.Tensor,        # [A, I] int64, pad = n
    alpha: float,
    sentinel: int,
    degree: int,
) -> torch.Tensor:
    old = adjacency[uniq]                                           # [A, R]
    cand_ids = torch.cat([old, inc], dim=1)
    cand_ids = torch.where(cand_ids == uniq[:, None], sentinel, cand_ids)
    new_rows = robust_prune_batch(
        vecs_dev[uniq], cand_ids, vecs_dev[cand_ids], sentinel, alpha,
        degree, precision="default",
    )
    # pad entries (uniq == sentinel) rewrite the sentinel row with its
    # existing all-sentinel contents
    adjacency[uniq] = new_rows
    return adjacency


def _apply_reverse_edges(
    adjacency: torch.Tensor,
    vecs_dev: torch.Tensor,
    dst: np.ndarray,
    src: np.ndarray,
    n: int,
    r: int,
    incoming_cap: int,
    alpha: float,
) -> Tuple[torch.Tensor, np.ndarray]:
    """For each edge p->q of the wave, add the reverse candidate p to
    N(q): group by q host-side (one integer sort), cap incoming per q,
    then blocks of batched robust prune on the device. Returns
    (adjacency, uniq updated-row ids [A])."""
    dev = vecs_dev.device
    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    uniq, starts = np.unique(dst_s, return_index=True)
    a = len(uniq)
    counts = np.diff(np.append(starts, len(dst_s)))
    take = np.minimum(counts, incoming_cap)
    inc = np.full((a, incoming_cap), n, dtype=np.int64)
    col = np.arange(incoming_cap)[None, :]
    gather_idx = starts[:, None] + col
    valid = col < take[:, None]
    inc[valid] = src_s[gather_idx[valid]]

    uniq = uniq.astype(np.int64)
    for start in range(0, a, REVERSE_BLOCK):
        block_u = torch.from_numpy(uniq[start : start + REVERSE_BLOCK]).to(dev)
        block_i = torch.from_numpy(inc[start : start + REVERSE_BLOCK]).to(dev)
        adjacency = _reverse_prune_block(
            adjacency, vecs_dev, block_u, block_i, alpha, n, r)
    return adjacency, uniq
