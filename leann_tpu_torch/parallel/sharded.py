"""Sharded search over a device mesh (port of `leann_tpu/parallel/sharded.py`).

The corpus is row-sharded across the mesh's `shard` axis; queries are
data-parallel over `dp` and replicated over `shard`. Each shard searches
its local block or subgraph on its own device, and the per-shard top-k
are moved to the dp row's first device, concatenated in shard order and
merged with one final top-k (`topk_stable`: ties to the lower position,
as the reference's all_gather + `jax.lax.top_k`). Local ids are rebased
to global ids with the shard offset. Across processes one all_gather of
the [b, k] scores and ids precedes the same final top-k (`parallel/
mesh.py`).

Four engines, as in the reference:
  ShardedFlatIndex   exact matmul top-k per shard
  ShardedGraphIndex  per-shard Vamana subgraph, searched by the plain
                     beam search ("xla"), kernel B1 ("fused") or kernel
                     B3 ("pq") on each shard
  ShardedIvfIndex    per-shard k-means buckets, bf16 scan, f32 rescore
  ShardedIvf8Index   per-shard residual-int8 buckets, rescored from the
                     same payload

The IVF engines run the plain scans (`ops/ivf.ivf_search`,
`ops/ivf_int8.ivf8_search`), as the reference's run XLA's, not kernels B4
or B2. Data that several dp rows share is held once per distinct device.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from leann_tpu_torch.device import free_device_bytes, kernels_available
from leann_tpu_torch.ops.distance import NEG_INF, pairwise_scores, topk_stable
from leann_tpu_torch.ops.fused_beam import _row_sq_norms
from leann_tpu_torch.parallel.mesh import Mesh


def _pad_rows(x: np.ndarray, rows: int, fill=0) -> np.ndarray:
    if x.shape[0] == rows:
        return x
    pad = np.full((rows - x.shape[0],) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad])


def _unit(x: np.ndarray) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)


def _none(q: torch.Tensor) -> torch.Tensor:
    """An `exclude` of -1 (no id excluded) for each query of q."""
    return torch.full((q.shape[0],), -1, dtype=torch.int32, device=q.device)


def _to_global(local_ids, local_scores, shard, rows, valid_n):
    """Local [b, k] results of one shard -> global ids and scores: ids
    rebased by shard * rows, the local sentinel (rows) mapped to valid_n,
    -1 kept; every id outside [0, valid_n) scores -inf."""
    ids = local_ids.to(torch.int64)
    gid = torch.where(ids < 0, -1,
                      torch.where(ids == rows, valid_n, ids + shard * rows))
    scores = torch.where((gid < 0) | (gid >= valid_n), NEG_INF,
                         local_scores.float())
    return gid, scores


class _Sharded:
    """What the four engines share: the metric rules, the shard layout,
    placement on the mesh and the merge."""

    def _setup(self, vectors: np.ndarray, mesh: Mesh,
               metric: str) -> np.ndarray:
        self.mesh = mesh
        self.metric_in = metric
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if metric == "cosine":
            vectors = _unit(vectors)
        self.metric = "ip" if metric == "cosine" else metric
        self.n, self.d = vectors.shape
        self.n_shards = mesh.shape["shard"]
        self.rows = -(-self.n // self.n_shards)  # rows per shard
        self.state = {}                          # shard -> {device: dict}
        return vectors

    def _local(self):
        m = self.mesh
        return range(m.shard_offset, m.shard_offset + m.local_shards)

    def _place(self, shard: int, tensors: dict) -> None:
        """Hold `tensors` once on each distinct device of the shard."""
        self.state[shard] = {
            dev: {k: v.to(dev) for k, v in tensors.items()}
            for dev in self.mesh.shard_devices(shard)}

    def _queries(self, queries, quant: int) -> Tuple[np.ndarray, int]:
        """Host queries as float32 [B_pad, D] (cosine: unit rows), padded
        with zero rows to a multiple of `quant`; and B."""
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if self.metric_in == "cosine":
            q = _unit(q)
        b = q.shape[0]
        return _pad_rows(q, -(-b // quant) * quant), b

    def _run(self, q: torch.Tensor, body: Callable, k_final: int,
             minus_one: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every local shard's body on every dp row of `q` [B, D] (B a
        multiple of dp), merged: (scores, ids) [B, k_final] on the
        mesh's first device. body(shard, state, q_row) -> (local scores,
        local ids) [b, k_local]. With `minus_one`, ids of -inf scores
        become -1 (the graph and IVF engines; flat keeps them)."""
        grid = self.mesh.grid
        dp = grid.shape[0]
        step = q.shape[0] // dp
        parts = [[] for _ in range(dp)]
        # every body is launched before any merge: shards on different
        # devices run at once
        for i in range(dp):
            qi = q[i * step : (i + 1) * step]
            for j, s in enumerate(self._local()):
                dev = grid[i, j]
                sc, ids = body(s, self.state[s][dev], qi.to(dev))
                parts[i].append(_to_global(ids, sc, s, self.rows, self.n))
        out_sc, out_ids = [], []
        for i in range(dp):
            first = grid[i, 0]
            sc = torch.cat([p[1].to(first) for p in parts[i]], dim=1)
            ids = torch.cat([p[0].to(first) for p in parts[i]], dim=1)
            top, pos = topk_stable(sc, min(k_final, sc.shape[1]))
            out_sc.append(top.to(grid[0, 0]))
            out_ids.append(torch.gather(ids, 1, pos).to(grid[0, 0]))
        sc, ids = torch.cat(out_sc), torch.cat(out_ids)
        if self.mesh.process_count > 1:
            sc = torch.cat(self.mesh.all_gather(sc), dim=1)
            ids = torch.cat(self.mesh.all_gather(ids), dim=1)
            sc, pos = topk_stable(sc, k_final)
            ids = torch.gather(ids, 1, pos)
        if minus_one:
            ids = torch.where(sc == NEG_INF, -1, ids)
        return sc, ids

    def _host(self, q: np.ndarray, b: int, body, k_final, minus_one):
        grid = self.mesh.grid
        sc, ids = self._run(torch.from_numpy(q).to(grid[0, 0]), body,
                            k_final, minus_one)
        return ids[:b].cpu().numpy(), sc[:b].cpu().numpy()


class ShardedFlatIndex(_Sharded):
    """Exact search, corpus row-sharded over the `shard` mesh axis."""

    def __init__(self, vectors: np.ndarray, mesh: Mesh, metric: str = "ip"):
        vectors = self._setup(vectors, mesh, metric)
        padded = _pad_rows(vectors, self.rows * self.n_shards)
        for s in self._local():
            v = torch.from_numpy(
                np.array(padded[s * self.rows : (s + 1) * self.rows]))
            self._place(s, {"vectors": v, "sq": _row_sq_norms(v)})

    def search(
        self, queries: np.ndarray, k: int = 10
    ) -> Tuple[np.ndarray, np.ndarray]:
        q, b = self._queries(queries, self.mesh.shape.get("dp", 1))
        k = min(k, self.n)
        return self._host(q, b, lambda s, st, qi: self._body(s, st, qi, k),
                          k, minus_one=False)

    def _body(self, s, st, q, k):
        scores = pairwise_scores(q, st["vectors"], self.metric,
                                 vector_sq_norms=st["sq"])   # [b, rows]
        col = torch.arange(self.rows, device=q.device) + s * self.rows
        scores = torch.where(col[None, :] < self.n, scores, NEG_INF)
        # k can exceed a shard's rows (tiny corpora, overfetched serving
        # k): each shard contributes what it has
        return topk_stable(scores, min(k, self.rows))


class ShardedGraphIndex(_Sharded):
    """Per-shard Vamana subgraphs searched shard by shard, then merged.

    Each shard builds its own graph over its valid rows and searches it
    locally. Engine choice mirrors `GraphSearcher`: on CUDA with kernel
    shapes (D % 128 == 0, R <= 128) each shard traverses with kernel B1
    when the int8 blocks of all the shards on a device fit 9/16 of its
    free memory; else, with R % 4 == 0 and a PQ split of D, kernel B3
    (one global codebook, replicated LUT operands, per-shard records and
    an exact local rescore) when their records and f32 rescore rows fit
    13/16; else (and always on the CPU) the plain beam search ("xla").
    Override with `engine="fused"|"pq"|"xla"` or LEANN_GRAPH_ENGINE. No
    engine falls back to another: a kernel that fails fails the search."""

    def __init__(
        self,
        vectors: np.ndarray,
        mesh: Mesh,
        metric: str = "ip",
        graph_degree: int = 32,
        complexity: int = 64,
        alpha: float = 1.2,
        adjacency_shards: Optional[np.ndarray] = None,
        medoids: Optional[np.ndarray] = None,
        build_wave_size: int = 1024,
        engine: str = "auto",
        qb: int = 16,
        seed: int = 0,
        rotation: Optional[np.ndarray] = None,  # [D, D] OPQ (pq engine)
    ):
        from leann_tpu_torch.ops.vamana import build_vamana

        vectors = self._setup(vectors, mesh, metric)
        rows, r = self.rows, graph_degree
        self.r = r
        padded = _pad_rows(vectors, rows * self.n_shards)
        # stacked per-shard layout [s, rows+1, ...]; local sentinel = rows
        vec_stack = np.zeros((self.n_shards, rows + 1, self.d), np.float32)
        adj_stack = np.full((self.n_shards, rows + 1, r), rows, np.int32)
        med = np.zeros(self.n_shards, np.int32)
        for s in range(self.n_shards):
            vec_stack[s, :rows] = padded[s * rows : (s + 1) * rows]
            if adjacency_shards is not None:
                adj_stack[s, :rows] = adjacency_shards[s]
                med[s] = medoids[s]
        for s in self._local():
            valid = min(rows, max(0, self.n - s * rows))
            if adjacency_shards is None and valid > 1:
                adj, medoid = build_vamana(
                    vec_stack[s, :valid], graph_degree=r,
                    complexity=complexity, alpha=alpha, metric=self.metric,
                    wave_size=build_wave_size,
                    device=mesh.shard_devices(s)[0])
                # rebase the local sentinel (== valid) to rows
                adj_stack[s, :valid] = np.where(adj >= valid, rows, adj)
                med[s] = medoid
        local = list(self._local())
        if mesh.process_count > 1 and adjacency_shards is None:
            got = mesh.gather_objects(
                [(adj_stack[s], med[s]) for s in local])
            adj_stack = np.stack([a for a, _ in got])
            med = np.asarray([m for _, m in got], np.int32)
        self.adjacency_shards = adj_stack[:, :rows]
        self.medoids_host = med
        sq_stack = (vec_stack * vec_stack).sum(axis=2)

        choice = engine
        if choice == "auto":
            choice = os.environ.get("LEANN_GRAPH_ENGINE", "auto")
        if choice == "auto":
            choice = self._auto_engine()
        self.engine = ("fused" if choice in ("fused", "inline")
                       else "pq" if choice == "pq" else "xla")
        self.qb = qb
        for s in local:
            base = {"vec": torch.from_numpy(vec_stack[s]),
                    "sq": torch.from_numpy(sq_stack[s])}
            if self.engine == "xla":
                base["adj"] = torch.from_numpy(adj_stack[s])
                base["medoid"] = torch.tensor(int(med[s]))
            self._place(s, base)
        if self.engine == "fused":
            self._init_fused(vec_stack, adj_stack, med, seed)
        elif self.engine == "pq":
            self._init_pq(vec_stack, adj_stack, med, seed, rotation)

    def _auto_engine(self) -> str:
        """The engine `GraphSearcher`'s policy picks, with the bytes of
        all the shards on one device summed before they are compared with
        that device's free memory."""
        per_dev = Counter(dev for s in self._local()
                          for dev in self.mesh.shard_devices(s))
        r, d, rows = self.r, self.d, self.rows
        if not all(kernels_available(dev) for dev in per_dev) or r > 128:
            return "xla"

        def fits(nbytes, share):
            return all(cnt * nbytes < free_device_bytes(dev) * share
                       for dev, cnt in per_dev.items())

        if d % 128 == 0 and fits((rows + 1) * r * d, 9 / 16):
            return "fused"
        m = next((mm for mm in (16, 12, 8) if d % mm == 0), 0)
        if m and r % 4 == 0:
            from leann_tpu_torch.ops.pq_beam import pq_layout

            cp = pq_layout(r, m, 8)[3]
            if fits((rows + 1) * cp * 512 + rows * d * 4, 13 / 16):
                return "pq"
        return "xla"

    def _seed_picks(self, rng, s, pool, med):
        """Shard s's seed pool: the reference's draw, medoid first,
        resized to `pool`."""
        valid = min(self.rows, max(1, self.n - s * self.rows))
        picks = rng.choice(valid, size=min(pool, valid),
                           replace=False).astype(np.int32)
        picks[0] = med[s]
        return np.resize(picks, pool)

    def _init_fused(self, vec_stack, adj_stack, med, seed):
        """Per-shard int8 blocks (`pack_fused` on the shard's device)
        and seed pools (true vectors in bf16)."""
        from leann_tpu_torch.ops.beam import seed_pool_size
        from leann_tpu_torch.ops.fused_beam import pack_fused

        rng = np.random.default_rng(seed)
        pool = seed_pool_size(self.rows)
        for s in range(self.n_shards):
            sid = self._seed_picks(rng, s, pool, med)
            if not self.mesh.is_local(s):
                continue
            first = self.mesh.shard_devices(s)[0]
            st = self.state[s][first]
            blocks, meta = pack_fused(
                st["vec"], torch.from_numpy(adj_stack[s]).to(first))
            sid_t = torch.from_numpy(sid.astype(np.int64))
            for dev, st in self.state[s].items():
                st.update(blocks=blocks.to(dev), meta=meta.to(dev),
                          seed_ids=sid_t.to(dev),
                          seed_vecs=st["vec"][sid_t.to(dev)].to(
                              torch.bfloat16))

    def _init_pq(self, vec_stack, adj_stack, med, seed, rotation):
        """One global codebook trained on a cross-shard sample (so the
        affine LUT operands are replicated), per-shard codes and records
        on the shard's devices, seeds scored through their
        reconstructions. With `rotation` (OPQ) codes are rotated-frame
        and the rotation folds into lut_w."""
        from leann_tpu_torch.ops.beam import seed_pool_size
        from leann_tpu_torch.ops.pq import (
            adc_affine, encode_pq, reconstruct_pq, train_pq)
        from leann_tpu_torch.ops.pq_beam import pack_pq_records

        rng = np.random.default_rng(seed)
        self.pq_m = next((mm for mm in (16, 12, 8) if self.d % mm == 0), 0)
        if not self.pq_m or self.r % 4 != 0:
            raise ValueError(
                f"pq engine needs d divisible by 16/12/8 and "
                f"R % 4 == 0 (d={self.d}, R={self.r})")
        self.pq_ksub = 256
        enc_stack = vec_stack
        self.rotation = None
        if rotation is not None:
            self.rotation = np.ascontiguousarray(rotation, np.float32)
            enc_stack = vec_stack @ self.rotation
        gids = rng.choice(self.n, size=min(262_144, self.n), replace=False)
        books = train_pq(
            enc_stack[gids // self.rows, gids % self.rows],
            m=self.pq_m, ksub=self.pq_ksub, iters=10, seed=seed,
            device=self.mesh.grid[0, 0])
        self.pq_books = books
        pool = seed_pool_size(self.rows)
        for s in range(self.n_shards):
            picks = self._seed_picks(rng, s, pool, med)
            if not self.mesh.is_local(s):
                continue
            dev0 = self.mesh.shard_devices(s)[0]
            codes = encode_pq(enc_stack[s], books, device=dev0)
            codes[self.rows] = 0          # sentinel row
            records = pack_pq_records(adj_stack[s], codes, 8, device=dev0)
            # seeds score via their RECONSTRUCTIONS so entry scores are
            # ADC-comparable with the kernel's beam scores
            shat = reconstruct_pq(codes[picks], books)
            snsq = np.einsum("pd,pd->p", shat, shat,
                             dtype=np.float64).astype(np.float32)
            if self.rotation is not None:
                shat = shat @ self.rotation.T
            shat_t = torch.from_numpy(np.ascontiguousarray(shat, np.float32))
            for dev, st in self.state[s].items():
                st.update(records=records.to(dev),
                          seed_ids=torch.from_numpy(
                              picks.astype(np.int64)).to(dev),
                          seed_vecs=shat_t.to(dev).to(torch.bfloat16),
                          seed_nsq=torch.from_numpy(snsq).to(dev))
        lut_w, lut_b = adc_affine(self.d, self.metric, None, books,
                                  self.pq_ksub)
        lut_w = lut_w.reshape(self.pq_m * self.pq_ksub, self.d)
        if self.rotation is not None:
            lut_w = lut_w @ self.rotation.T
        lut_w = torch.from_numpy(np.ascontiguousarray(lut_w, np.float32))
        lut_b = torch.from_numpy(np.ascontiguousarray(
            lut_b.reshape(self.pq_m * self.pq_ksub), np.float32))
        # replicated (small): held once per device, shared by its shards
        luts = {}
        for s in self._local():
            for dev, st in self.state[s].items():
                if dev not in luts:
                    luts[dev] = (lut_w.to(dev), lut_b.to(dev))
                st["lut_w"], st["lut_b"] = luts[dev]

    # ------------------------------------------------------------ search

    def _quant(self) -> int:
        dp = self.mesh.shape.get("dp", 1)
        return dp * (self.qb if self.engine in ("fused", "pq") else 1)

    def search(
        self, queries: np.ndarray, k: int = 10, beam_width: int = 64
    ) -> Tuple[np.ndarray, np.ndarray]:
        q, b = self._queries(queries, self._quant())
        k_eff = min(k, self.rows)
        return self._host(q, b, self._body(k_eff, beam_width), k_eff,
                          minus_one=True)

    def search_device(self, queries: torch.Tensor, k: int = 10,
                      beam_width: int = 64):
        """Device-in, device-out search: `queries` [B, D] float32 on the
        mesh's first device, already unit rows for cosine and B a
        multiple of dp (times qb for the kernel engines). Returns (ids,
        scores) [B, min(k, rows)] there, with no read back to the host."""
        if queries.shape[0] % self._quant():
            raise ValueError(f"B={queries.shape[0]} must be a multiple of "
                             f"{self._quant()}")
        k_eff = min(k, self.rows)
        sc, ids = self._run(queries, self._body(k_eff, beam_width), k_eff,
                            minus_one=True)
        return ids, sc

    def kernel_args(self, queries: torch.Tensor, beam_width: int,
                    shard: int = 0) -> dict:
        """The kernel arguments of one shard's body for a query batch on
        that shard's first device: `fused_beam_search`'s (engine "fused")
        or `pq_beam_search`'s (engine "pq")."""
        st = self.state[shard][queries.device]
        if self.engine == "fused":
            return self._fused_args(st, queries, beam_width)
        if self.engine == "pq":
            return self._pq_args(st, queries, beam_width)
        raise ValueError(f"engine {self.engine!r} launches no kernel")

    def _body(self, k: int, beam_width: int):
        """The shard body of this engine: (local scores, local ids)."""
        from leann_tpu_torch.ops.beam import _rescore, beam_search_batch
        from leann_tpu_torch.ops.fused_beam import (
            _dedup_candidates, fused_beam_search)
        from leann_tpu_torch.ops.pq_beam import pq_beam_search

        def xla(s, st, q):
            beam_ids, beam_scores = beam_search_batch(
                q, st["vec"], st["adj"], st["sq"], st["medoid"], _none(q),
                beam_width=beam_width, max_iters=4 * beam_width + 32,
                metric=self.metric)
            return beam_scores[:, :k], beam_ids[:, :k]

        def fused(s, st, q):
            beam_ids, _ = fused_beam_search(
                **self._fused_args(st, q, beam_width))
            # exact f32 rescore against the local corpus block
            ids, scores = _rescore(q, st["vec"], st["sq"],
                                   beam_ids.to(torch.int64), self.rows,
                                   self.metric, k)
            return scores, ids

        def pq(s, st, q):
            beam_ids, _, vlog = pq_beam_search(
                **self._pq_args(st, q, beam_width))
            cand = _dedup_candidates(beam_ids.to(torch.int64),
                                     vlog.to(torch.int64), self.rows)
            ids, scores = _rescore(q, st["vec"], st["sq"], cand, self.rows,
                                   self.metric, k)
            return scores, ids

        return {"xla": xla, "fused": fused, "pq": pq}[self.engine]

    def _entries(self, sd, seed_ids):
        """The 16 best seeds of the pool (ties to the lower position)."""
        entry_sc, best = topk_stable(sd, min(16, seed_ids.shape[0]))
        return seed_ids[best].to(torch.int32), entry_sc.contiguous()

    def _fused_args(self, st, q, beam_width):
        # seeds scored with bf16 operands, float32 products and sums
        sd = q.to(torch.bfloat16).float() @ st["seed_vecs"].float().T
        if self.metric == "l2":
            sd = 2.0 * sd - st["sq"][st["seed_ids"]][None, :]
        entry, entry_sc = self._entries(sd, st["seed_ids"])
        return dict(
            queries=q, blocks_i8=st["blocks"], meta_i32=st["meta"],
            seed_ids=entry, seed_scores=entry_sc, exclude=_none(q),
            r=self.r, beam_width=beam_width,
            max_iters=(4 * beam_width) // 2 + 32, metric=self.metric,
            expansions=2, qb=self.qb, ring_size=1024, track_visited=0)

    def _pq_args(self, st, q, beam_width):
        luts = q @ st["lut_w"].T + st["lut_b"][None, :]
        # entry scores via seed reconstructions: ADC-comparable with the
        # kernel's beam scores (exact seed scores would not be)
        sd = q.to(torch.bfloat16).float() @ st["seed_vecs"].float().T
        if self.metric == "l2":
            sd = 2.0 * sd - st["seed_nsq"][None, :]
        entry, entry_sc = self._entries(sd, st["seed_ids"])
        return dict(
            luts=luts.contiguous(), records=st["records"], seed_ids=entry,
            seed_scores=entry_sc, exclude=_none(q),
            r=self.r, m=self.pq_m, ksub=self.pq_ksub, bits=8,
            beam_width=beam_width, max_iters=(4 * beam_width) // 2 + 32,
            expansions=2, qb=self.qb, ring_size=1024, track_visited=256)


def _stack_tables(mesh, per_shard, fills):
    """Pad each local shard's bucket tables (ids, centroids, then tables
    of [K', cap, ...]) to the K' and cap common to all shards (maxima
    over every process), as the reference stacks them. Pad centroid rows
    may be probed; their buckets hold only sentinel ids."""
    kp, cp = mesh.max_over_processes(
        [max(t[0].shape[0] for t in per_shard.values()),
         max(t[0].shape[1] for t in per_shard.values())])
    out = {}
    for s, tabs in per_shard.items():
        out[s] = []
        for i, (t, fill) in enumerate(zip(tabs, fills)):
            shape = (kp,) + t.shape[1:] if i == 1 else (kp, cp) + t.shape[2:]
            full = np.full(shape, fill, t.dtype)
            full[tuple(slice(0, x) for x in t.shape)] = t
            out[s].append(full)
    return out, kp


class ShardedIvfIndex(_Sharded):
    """Per-shard IVF: each shard runs k-means over its rows, scans its
    probed buckets in bf16 and contributes its top-k to the merge. The
    merged candidates are rescored in f32 against the corpus on the host
    (a gather of B*k rows)."""

    def __init__(
        self,
        vectors: np.ndarray,
        mesh: Mesh,
        metric: str = "ip",
        n_clusters: Optional[int] = None,
        kmeans_iters: int = 8,
        cap: Optional[int] = None,
        seed: int = 0,
        centers_shards: Optional[list] = None,  # per-shard [K_s, D] f32
        assign_shards: Optional[list] = None,   # per-shard [valid_s] int32
    ):
        from leann_tpu_torch.ops.ivf import kmeans, pack_buckets

        vectors = self._setup(vectors, mesh, metric)
        self.vectors = vectors
        rows = self.rows
        padded = _pad_rows(vectors, rows * self.n_shards)
        per_shard = {}
        # kept for persistence (store/shardfile.py)
        centers_host, assign_host = [], []
        for s in self._local():
            block = padded[s * rows : (s + 1) * rows]
            valid = min(rows, max(1, self.n - s * rows))
            if centers_shards is not None and assign_shards is not None:
                centers = np.asarray(centers_shards[s], np.float32)
                assign = np.asarray(assign_shards[s], np.int32)
            else:
                k = n_clusters or max(16, int(2 * valid ** 0.5))
                centers, assign = kmeans(
                    block[:valid], min(k, valid), iters=kmeans_iters,
                    metric=self.metric, seed=seed + s,
                    device=mesh.shard_devices(s)[0])
            centers_host.append(np.asarray(centers, np.float32))
            assign_host.append(np.asarray(assign, np.int32))
            ids, cent, vecs = pack_buckets(block[:valid], assign, centers,
                                           cap=cap)
            # local sentinel: rebase "valid" to rows
            per_shard[s] = (np.where(ids >= valid, rows, ids), cent, vecs)
        self.centers_host = mesh.gather_objects(centers_host)
        self.assign_host = mesh.gather_objects(assign_host)
        tables, self.n_buckets = _stack_tables(
            mesh, per_shard, (rows, 0.0, 0.0))
        for s, (ids, cent, vecs) in tables.items():
            self._place(s, {
                "ids": torch.from_numpy(ids),
                "cent": torch.from_numpy(cent),
                "vecs": torch.from_numpy(vecs).to(torch.bfloat16),
                "sq": torch.from_numpy((vecs * vecs).sum(axis=2))})

    def search(
        self, queries: np.ndarray, k: int = 10, nprobe: int = 16
    ) -> Tuple[np.ndarray, np.ndarray]:
        from leann_tpu_torch.ops.ivf import ivf_search

        qp, b = self._queries(queries, self.mesh.shape.get("dp", 1))
        q = qp[:b]
        k_eff = min(k, self.rows)
        nprobe = min(nprobe, self.n_buckets)

        def body(s, st, qi):
            return ivf_search(qi, st["cent"], st["ids"], st["vecs"],
                              st["sq"], k=k_eff, nprobe=nprobe,
                              metric=self.metric, sentinel=self.rows)

        idx, _ = self._host(qp, b, body, k_eff, minus_one=True)
        # f32 rescore of the merged candidates (a small host gather)
        safe = np.clip(idx, 0, self.n - 1)
        vecs = self.vectors[safe]                       # [B, k, D]
        dots = np.einsum("bkd,bd->bk", vecs, q)
        if self.metric == "l2":
            rescored = 2.0 * dots - (vecs * vecs).sum(axis=2)
        else:
            rescored = dots
        rescored = np.where(idx >= 0, rescored, -np.inf)
        order = np.argsort(-rescored, axis=1)
        return np.take_along_axis(idx, order, axis=1), np.take_along_axis(
            rescored, order, axis=1
        )


class ShardedIvf8Index(_Sharded):
    """Per-shard ivf8: the residual-int8 payload scanned on each shard,
    reranked from the same payload, then merged. No f32 corpus is held
    anywhere: per shard 1 byte a dimension of payload plus the scale and
    |x|^2 sidecars, and the final scores are exact f32 dequants of the
    payload (`ops/ivf_int8.py`)."""

    def __init__(
        self,
        vectors: np.ndarray,
        mesh: Mesh,
        metric: str = "ip",
        n_clusters: Optional[int] = None,
        kmeans_iters: int = 8,
        cap: Optional[int] = None,
        seed: int = 0,
    ):
        from leann_tpu_torch.ops.ivf import kmeans
        from leann_tpu_torch.ops.ivf_int8 import pack_int8_buckets

        vectors = self._setup(vectors, mesh, metric)
        rows = self.rows
        padded = _pad_rows(vectors, rows * self.n_shards)
        per_shard = {}
        for s in self._local():
            block = padded[s * rows : (s + 1) * rows]
            valid = min(rows, max(1, self.n - s * rows))
            k = n_clusters or max(16, int(2 * valid ** 0.5))
            centers, assign = kmeans(
                block[:valid], min(k, valid), iters=kmeans_iters,
                metric=self.metric, seed=seed + s,
                device=mesh.shard_devices(s)[0])
            ids, cent, payload, scale, nsq = pack_int8_buckets(
                block[:valid], assign, centers, cap=cap)
            # rebase the pack sentinel (= valid) to the common `rows`
            per_shard[s] = (np.where(ids >= valid, rows, ids), cent,
                            payload, scale, nsq)
        tables, self.n_buckets = _stack_tables(
            mesh, per_shard, (rows, 0.0, 0, 0.0, 0.0))
        for s, (ids, cent, payload, scale, nsq) in tables.items():
            self._place(s, {
                "ids": torch.from_numpy(ids), "cent": torch.from_numpy(cent),
                "payload": torch.from_numpy(payload),
                "scale": torch.from_numpy(scale),
                "nsq": torch.from_numpy(nsq)})

    def search(
        self, queries: np.ndarray, k: int = 10, nprobe: int = 16,
        rescore_factor: int = 4,
    ) -> Tuple[np.ndarray, np.ndarray]:
        from leann_tpu_torch.ops.ivf_int8 import ivf8_search

        q, b = self._queries(queries, self.mesh.shape.get("dp", 1))
        # k may exceed rows per shard (tiny corpora, serving overfetch):
        # each shard contributes its min(k, rows) best and the merge
        # returns min(k, n) columns, as ShardedFlatIndex does
        k_local = min(k, self.rows)
        k_final = min(k, self.n)
        c = min(max(rescore_factor * k_local, k_local), self.rows)
        nprobe = min(nprobe, self.n_buckets)

        def body(s, st, qi):
            ids, scores = ivf8_search(
                qi, st["cent"], st["ids"], st["payload"], st["scale"],
                st["nsq"], k=k_local, c=c, nprobe=nprobe,
                metric=self.metric, sentinel=self.rows)
            return scores, ids

        return self._host(q, b, body, k_final, minus_one=True)
