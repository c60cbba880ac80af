"""IVF (inverted-file) index: k-means partitioning + dense bucket scoring
(port of `leann_tpu/ops/ivf.py`).

Search is three steps of matrix-shaped work:

    1. score all centroids:      Q @ C.T              one GEMM
    2. pick top-nprobe clusters per query              one top-k
    3. scan the nprobe probed buckets in bf16 and keep the top-C of
       their slots; the C survivors are rescored in f32

Step 3 is `ivf_search` (`IvfEngine.search`, what `IvfSearcher` serves; the
reference left it to XLA outside any kernel), and the tensors' device
picks its one path. On the card kernel B4 (`ops/bucket_kernels.py`)
scores the probed buckets and kernel `ivf_topc` (`ops/ivf_topc.py`) keeps
the top-C; on the CPU each probe gathers a [B, cap, D] block of bf16
bucket vectors, scores it as a batched product and merges a running
top-C. The build is k-means on the device.

Bucket layout: vectors are re-packed into [K', cap, D] padded buckets
(cap ~= 1.3 x mean occupancy); rows beyond cap spill into extra buckets
that share the parent centroid, so nothing is dropped and the top-nprobe
centroid scoring probes them (a duplicated centroid scores identically).
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from leann_tpu_torch.device import DeviceLike, resolve_device
from leann_tpu_torch.ops import _cuda
from leann_tpu_torch.ops.distance import (
    NEG_INF, _rescore_topk, pairwise_scores, topk_stable,
)
from leann_tpu_torch.utils.trace import device_span, tracing


# ---------------------------------------------------------------- k-means


def _assign_chunked(vectors, centers, metric, chunk) -> torch.Tensor:
    """[N] nearest center per row (argmax of the scores, first index on
    ties), in row chunks."""
    return torch.cat([
        pairwise_scores(vectors[s : s + chunk], centers, metric).argmax(1)
        for s in range(0, vectors.shape[0], chunk)])


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic mode for the block, then the caller's mode
    again. In it `index_add_` on CUDA sums each row's contributions in
    index order (a sort, then a segment sum) instead of with atomics, whose
    order changes from run to run."""
    mode = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(mode, warn_only=warn)


def _kmeans_update(v_dev, assign, centers_prev, k: int) -> torch.Tensor:
    """New centers: the mean of each cluster's rows (an empty cluster
    keeps its center), summed in a fixed order, so a seed gives the same
    bits on every run, as the reference's `segment_sum` does."""
    d = v_dev.shape[1]
    sums = torch.zeros((k, d), dtype=torch.float32, device=v_dev.device)
    counts = torch.zeros((k,), dtype=torch.float32, device=v_dev.device)
    with _deterministic():
        sums.index_add_(0, assign, v_dev)
        counts.index_add_(0, assign,
                          torch.ones_like(assign, dtype=torch.float32))
    fresh = sums / counts.clamp_min(1.0)[:, None]
    return torch.where((counts > 0)[:, None], fresh, centers_prev)


def kmeans(
    vectors: np.ndarray,
    k: int,
    iters: int = 8,
    metric: str = "l2",
    seed: int = 0,
    chunk: int = 65536,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd's algorithm on `device`. Returns (centers [K, D] f32,
    assign [N] int32); the initial centers are the reference's numpy
    draw."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n, _ = vectors.shape
    chunk = min(chunk, 1 << max(8, (n - 1).bit_length()))
    v_host = np.ascontiguousarray(vectors, dtype=np.float32)
    v_dev = torch.from_numpy(v_host).to(dev)
    centers = torch.from_numpy(
        v_host[rng.choice(n, size=k, replace=n < k)]).to(dev)
    for _ in range(iters):
        assign = _assign_chunked(v_dev, centers, metric, chunk)
        centers = _kmeans_update(v_dev, assign, centers, k)
    assign = _assign_chunked(v_dev, centers, metric, chunk)
    return (centers.cpu().numpy(),
            assign.to(torch.int32).cpu().numpy())


# ---------------------------------------------------------------- packing


def bucket_rows(assign: np.ndarray, k: int, n: int, cap: Optional[int]):
    """(cap, [(cluster, row ids)]) of the padded bucket layout that every
    IVF engine packs: cap defaults to 1.3 x the mean occupancy (at least
    8), a cluster's rows keep their corpus order, rows beyond cap spill
    into further buckets of the same cluster, and an empty cluster keeps
    one empty bucket."""
    counts = np.bincount(assign, minlength=k)
    if cap is None:
        cap = max(8, int(np.ceil(1.3 * n / k)))
    order = np.argsort(assign, kind="stable")
    starts = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    rows = []
    for c in range(k):
        ids = order[starts[c]:starts[c + 1]]
        for off in range(0, max(len(ids), 1), cap):
            part = ids[off : off + cap]
            if len(part) == 0 and off > 0:
                break
            rows.append((c, part))
    return cap, rows


def pack_buckets(
    vectors: np.ndarray,
    assign: np.ndarray,
    centers: np.ndarray,
    cap: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (bucket_ids [K', cap], bucket_centroids [K', D],
    bucket_vecs [K', cap, D]). K' >= K because overflow rows become
    additional buckets sharing the parent centroid."""
    n, d = vectors.shape
    cap, bucket_rows_ = bucket_rows(assign, centers.shape[0], n, cap)
    kp = len(bucket_rows_)
    bucket_ids = np.full((kp, cap), n, dtype=np.int32)   # sentinel = n
    bucket_cent = np.zeros((kp, d), dtype=np.float32)
    bucket_vecs = np.zeros((kp, cap, d), dtype=np.float32)
    for row, (c, ids) in enumerate(bucket_rows_):
        bucket_ids[row, : len(ids)] = ids
        bucket_cent[row] = centers[c]
        if len(ids):
            bucket_vecs[row, : len(ids)] = vectors[ids]
    return bucket_ids, bucket_cent, bucket_vecs


# ---------------------------------------------------------------- search


def device_queries(queries, device, metric_in) -> torch.Tensor:
    """[B, D] f32 queries on `device`, normalized for cosine engines."""
    q = torch.as_tensor(queries, dtype=torch.float32, device=device)
    if q.dim() == 1:
        q = q[None, :]
    if metric_in == "cosine":
        q = q / (torch.linalg.vector_norm(q, dim=1, keepdim=True) + 1e-12)
    return q


# batch shapes whose CUDA graphs an engine keeps, the least recently used
# dropped first (`IvfEngine.search_many_device`)
_GRAPH_SHAPES = 4


def search_sizes(engine, k, nprobe, rescore_factor) -> Tuple[int, int, int]:
    """(k, nprobe, candidates to rescore) of an IVF engine's search,
    clamped to its corpus and bucket counts."""
    nprobe = min(nprobe, engine.bucket_cent.shape[0])
    k = min(k, engine.n)
    return k, nprobe, min(max(rescore_factor * k, k), engine.n)


class IvfEngine:
    """bf16 bucket scan + f32 rescore against the resident corpus, on
    `device` (default cuda)."""

    def __init__(
        self,
        vectors: np.ndarray,
        n_clusters: Optional[int] = None,
        metric: str = "ip",
        kmeans_iters: int = 8,
        cap: Optional[int] = None,
        seed: int = 0,
        centers: Optional[np.ndarray] = None,
        assign: Optional[np.ndarray] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.metric_in = metric
        if metric == "cosine":
            vectors = vectors / (
                np.linalg.norm(vectors, axis=1, keepdims=True) + 1e-12
            )
            metric = "ip"
        self.metric = metric
        self.n, self.d = vectors.shape
        if n_clusters is None:
            n_clusters = max(16, int(np.sqrt(self.n) * 2))
        self.n_clusters = min(n_clusters, self.n)

        if centers is None or assign is None:
            centers, assign = kmeans(
                vectors, self.n_clusters, iters=kmeans_iters,
                metric=self.metric, seed=seed, device=self.device,
            )
        bucket_ids, bucket_cent, bucket_vecs = pack_buckets(
            vectors, assign, centers, cap=cap
        )
        dev = self.device
        self.centers = centers
        self.assign = assign
        self.cap = bucket_ids.shape[1]
        self.bucket_ids = torch.from_numpy(bucket_ids).to(dev)
        self.bucket_cent = torch.from_numpy(bucket_cent).to(dev)
        # bucket vectors live only as bf16 (the scan type); exact scores
        # come from the f32 corpus at rescore time. |v|^2 is summed on the
        # host, as the reference does (the same bits).
        self.bucket_vecs_bf16 = torch.from_numpy(bucket_vecs).to(dev).to(
            torch.bfloat16)
        self.bucket_sq = torch.from_numpy(
            (bucket_vecs * bucket_vecs).sum(axis=2)).to(dev)
        del bucket_vecs
        self.bucket_live = (self.bucket_ids != self.n).sum(1)   # [K']
        self._corpus_dev = torch.from_numpy(vectors).to(dev)
        # batch shape -> its `_BatchGraphs`, or None once seen in one call
        self._graphs = collections.OrderedDict()
        self._graph_lock = threading.Lock()
        self._capture_stream = None

    def search(
        self, queries, k: int = 10, nprobe: int = 32,
        rescore_factor: int = 4,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Buckets are scanned in bf16 (f32 accumulation; `ivf_search`,
        kernels B4 and `ivf_topc` on the card); the rescore_factor*k
        survivors are rescored at full f32 against the resident corpus.
        Returns numpy (ids, scores)."""
        ids, scores = self.search_device(
            queries, k=k, nprobe=nprobe, rescore_factor=rescore_factor)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def search_device(
        self, queries, k: int = 10, nprobe: int = 32,
        rescore_factor: int = 4,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-out search: (ids, scores) on the device."""
        return self._search(device_queries(queries, self.device,
                                           self.metric_in),
                            k, nprobe, rescore_factor)

    def _search(self, q, k, nprobe, rescore_factor):
        k, nprobe, c = search_sizes(self, k, nprobe, rescore_factor)
        _, cand = ivf_search(
            q, self.bucket_cent, self.bucket_ids, self.bucket_vecs_bf16,
            self.bucket_sq, k=c, nprobe=nprobe, metric=self.metric,
            sentinel=self.n, bucket_live=self.bucket_live,
        )
        scores, ids = _stage("ivf.rescore", lambda: _rescore_topk(
            q, self._corpus_dev, cand, k, self.metric))
        return ids, scores

    def search_many_device(
        self, qs, k: int = 10, nprobe: int = 32, rescore_factor: int = 4,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[M, B, D] device-resident query batches -> (ids, scores) each
        [M, B, k], one batch after another (the reference's lax.scan). The
        queries go in as they are, as in the reference: a cosine engine's
        scores then carry |q|.

        How a batch is launched depends on what the call sees. CUDA
        queries of a batch shape seen in an earlier call, whose scan is
        one query chunk, replay that shape's CUDA graphs (`_BatchGraphs`:
        `_search` captured, so the same launches and bits); the shape's
        first call runs eagerly, the second captures, and no capture
        happens while tracing is on. An engine keeps `_GRAPH_SHAPES`
        shapes, the least recently used dropped first with its memory
        pool. CPU queries, and every other call, run each batch eagerly
        (`_search`).
        `search_many_device.paths` counts batches by path (`eager`,
        `capture`, `replay`); while tracing, `traced_batches` and
        `traced_replays` count the batches and those that replayed.

        Device spans: `ivf.search_many` around the call; per batch
        `ivf_search`'s (`ivf.probe`, then `ivf.scan` and `ivf.merge`) and
        `ivf.rescore` (`_rescore_topk`), around a replay the span its
        graph was captured from."""
        many = IvfEngine.search_many_device
        traced = tracing()
        m, b = qs.shape[0], qs.shape[1]
        k, nprobe, c = search_sizes(self, k, nprobe, rescore_factor)
        with device_span("ivf.search_many"):
            ids = torch.empty((m, b, k), dtype=torch.int64, device=self.device)
            scores = torch.empty((m, b, k), dtype=torch.float32,
                                 device=self.device)
            graphs, path = self._graphs_for(qs, k, nprobe, rescore_factor,
                                            c, traced)
            for i, q in enumerate(qs):
                if graphs is None:
                    ids[i], scores[i] = self._search(q.to(torch.float32), k,
                                                     nprobe, rescore_factor)
                else:
                    with self._graph_lock:
                        graphs.run(q, ids[i], scores[i])
                _cuda.count_path(many, path)
                if traced:
                    _cuda.count_work(many, traced_batches=1,
                                     traced_replays=int(path == "replay"))
                if path == "capture":
                    path = "replay"
            return ids, scores

    def _graphs_for(self, qs, k, nprobe, rescore_factor, c, traced):
        """(the `_BatchGraphs` of the batch shape of `qs`, or None, and the
        path of the call's first batch): CUDA queries whose scan is one
        query chunk, on the shape's second sighting or later and, for a
        capture, with tracing off; the capture warms up on `qs[0]`."""
        m, b = qs.shape[0], qs.shape[1]
        if not qs.is_cuda or m == 0 or b == 0 or \
                b > _scan_chunk(nprobe, self.cap, c):
            return None, "eager"
        key = (tuple(qs.shape[1:]), qs.dtype, k, nprobe, c)
        with self._graph_lock:
            if key not in self._graphs:
                self._graphs[key] = None
                while len(self._graphs) > _GRAPH_SHAPES:
                    self._graphs.popitem(last=False)
                return None, "eager"
            self._graphs.move_to_end(key)
            graphs = self._graphs[key]
            if graphs is not None:
                return graphs, "replay"
            if traced:
                return None, "eager"
            graphs = self._graphs[key] = _BatchGraphs(self, qs[0], k, nprobe,
                                                      rescore_factor)
            return graphs, "capture"

    def calibrate_nprobe(
        self,
        target_recall: float = 0.95,
        k: int = 10,
        sample: int = 256,
        ladder: Tuple[int, ...] = (4, 8, 16, 32, 64, 128, 256),
        seed: int = 1,
    ) -> Tuple[int, float]:
        """Smallest nprobe meeting `target_recall` on this corpus: a ladder
        of nprobe values on `sample` self-queries (corpus rows plus
        cluster-residual-scaled noise) against the engine's own
        exhaustive-probe search; the first rung that meets the target and
        its recall (see `calibrate_nprobe_ladder`)."""
        idx = np.random.default_rng(seed).integers(0, self.n, sample)
        base = self._corpus_dev[torch.from_numpy(idx).to(self.device)]
        return calibrate_nprobe_ladder(
            self, base.cpu().numpy(), idx, target_recall=target_recall, k=k,
            ladder=ladder, seed=seed)


IvfEngine.search_many_device.paths = {"eager": 0, "capture": 0, "replay": 0}
IvfEngine.search_many_device.traced_batches = 0
IvfEngine.search_many_device.traced_replays = 0


_CAPTURE = threading.local()


def _stage(name: str, fn):
    """`fn()` under the device span `name`; inside this thread's
    `_BatchGraphs` capture, `fn` captured into that span's graph."""
    graphs = getattr(_CAPTURE, "graphs", None)
    if graphs is not None:
        return graphs.stage(name, fn)
    with device_span(name):
        return fn()


class _BatchGraphs:
    """One batch shape's work on a CUDA engine as CUDA graphs, one per
    span of `_search` (`ivf.probe`, `ivf.scan`, `ivf.merge`,
    `ivf.rescore` for a batch whose scan is one query chunk, as every
    device op of such a batch lies in one of them), captured in order
    into one private memory pool and replayed in that order: `_search`
    itself is captured, so a replay makes its launches and gives its
    bits. A batch's queries are copied into `q`; its answers are read
    from `ids` and `scores`.

    The capture runs on the engine's capture stream after one eager
    `_search` there on the first batch, so lazy set-up (cuBLAS's
    workspace for the stream, `ivf_topc`'s shared-memory query) happens
    outside it. The warm-up's counts are dropped; those the capture made
    (`_cuda.deferred_counts`) are added at each replay. The native
    launchers allocate nothing, do not synchronise and read nothing
    back."""

    def __init__(self, eng: IvfEngine, first: torch.Tensor, k: int,
                 nprobe: int, rescore_factor: int):
        dev = eng.device
        self.bucket_live = eng.bucket_live
        self.q = torch.empty(first.shape, dtype=torch.float32, device=dev)
        self.q.copy_(first)
        self.graphs = []      # (span, graph), in capture order
        self._pool = torch.cuda.graph_pool_handle()
        if eng._capture_stream is None:
            eng._capture_stream = torch.cuda.Stream(dev)
        stream = eng._capture_stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            with _cuda.deferred_counts():
                eng._search(self.q, k, nprobe, rescore_factor)
            _CAPTURE.graphs = self
            try:
                with _cuda.deferred_counts() as self.counts:
                    self.ids, self.scores = eng._search(self.q, k, nprobe,
                                                        rescore_factor)
            finally:
                _CAPTURE.graphs = None
        torch.cuda.current_stream(dev).wait_stream(stream)

    def stage(self, name: str, fn):
        """Capture `fn`'s launches into a graph for span `name`."""
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
        self.graphs.append((name, graph))
        if name == "ivf.probe":
            self.probe = out
        return out

    def run(self, q: torch.Tensor, ids: torch.Tensor,
            scores: torch.Tensor) -> None:
        """One batch: `q` [B, D] in, its answers written into `ids` and
        `scores` [B, k]; each graph replayed under its span, the probed
        rows counted after the probe while tracing (as `ivf_search` counts
        them), and the capture's counts added."""
        self.q.copy_(q)
        for name, graph in self.graphs:
            with device_span(name):
                graph.replay()
            if name == "ivf.probe":
                _count_rows(self.probe, self.bucket_live)
        _cuda.add_counts(self.counts)
        ids.copy_(self.ids)
        scores.copy_(self.scores)


def calibrate_nprobe_ladder(
    engine,                  # any IVF engine: .search/.n_clusters/...
    base: np.ndarray,        # [sample, D] f32 corpus rows to query near
    idx: np.ndarray,         # [sample] their corpus row ids
    target_recall: float = 0.95,
    k: int = 10,
    ladder: Tuple[int, ...] = (4, 8, 16, 32, 64, 128, 256),
    seed: int = 1,
    frame_base: Optional[np.ndarray] = None,  # base in the centers' frame
) -> Tuple[int, float]:
    """Shared ladder walk of the IVF engines (`IvfEngine.calibrate_nprobe`
    documents it)."""
    rng = np.random.default_rng(seed)
    fb = base if frame_base is None else frame_base
    resid = fb - engine.centers[engine.assign[idx]]
    rstd = float(resid.std()) or 1e-3
    q = base + rstd * rng.standard_normal(base.shape).astype(np.float32)
    if engine.metric_in == "cosine":
        q = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-12)

    oracle, _ = engine.search(q, k=k, nprobe=engine.n_clusters)
    osets = [set(row.tolist()) for row in oracle]
    best = (engine.n_clusters, 1.0)
    for nprobe in ladder:
        if nprobe >= engine.n_clusters:
            break
        ids, _ = engine.search(q, k=k, nprobe=nprobe)
        rec = float(np.mean([
            len(set(row.tolist()) & osets[i]) / k
            for i, row in enumerate(ids)
        ]))
        if rec >= target_recall:
            return nprobe, rec
    return best


def ivf_search(
    queries, centroids, bucket_ids, bucket_vecs, bucket_sq,
    k: int, nprobe: int, metric: str, sentinel: int,
    bucket_live: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage-1 candidate generation: bf16 bucket scan (exact float32
    products of bf16 values, float32 sums) and the exact top-k over the
    probes' slots (ties to the earlier probe, then the lower slot); callers
    rescore the survivors in f32 (IvfEngine.search). Returns (scores
    [B, k], ids [B, k] int64, -1 for empty slots).

    The tensors' device picks the path; nothing else does, and
    `ivf_search.paths` counts each. CUDA tensors take the kernels
    (`_kernel_scan`): kernel B4 scores the probed buckets and kernel
    `ivf_topc` keeps the top-k of its dots. CPU tensors take the plain
    scan: per probe a gather of the bucket rows, the batched product, the
    l2 fold and the sentinel mask, and a running top-k (`cat`,
    `topk_stable`, `gather`). The two return the same top-k of the same
    dots (`ops/ivf_topc.py`), which is also the top-k of the reference's
    two scans (its running merge and its Pallas path's one top-k over
    [B, P*cap]); the dots differ only in the order of their float32 sums.

    Device spans: `ivf.probe` (the centroid scores and top-nprobe), then
    `ivf.scan` (B4 with its work list's key sort; on the CPU per probe the
    gather, product, fold and masks) and `ivf.merge` (the select; on the
    CPU per probe the running top-k). While tracing is on
    (`utils.trace.tracing`), a call given `bucket_live` ([K'], each
    bucket's live, non-sentinel rows) adds the live rows of its probed
    buckets, summed on the device, to `ivf_search.rows` and its queries to
    `ivf_search.traced_queries`, under `_cuda.count_work`'s lock and with
    no sync."""
    b = queries.shape[0]
    dev = queries.device
    probe = _stage("ivf.probe", lambda: topk_stable(
        pairwise_scores(queries, centroids, metric), nprobe)[1])   # [B, P]
    if bucket_live is not None:
        _count_rows(probe, bucket_live)
    if dev.type == "cuda":
        _cuda.count_path(ivf_search, "kernel")
        return _kernel_scan(queries, probe, bucket_ids, bucket_vecs,
                            bucket_sq, k, metric, sentinel)
    _cuda.count_path(ivf_search, "torch")
    q_score = queries.to(torch.bfloat16).float()
    best_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    best_ids = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for p in range(nprobe):
        with device_span("ivf.scan"):
            cluster = probe[:, p]                            # [B]
            vecs = bucket_vecs[cluster].float()              # [B, cap, D]
            ids = bucket_ids[cluster].long()                 # [B, cap]
            dots = torch.einsum("bcd,bd->bc", vecs, q_score)
            scores = (2.0 * dots - bucket_sq[cluster] if metric == "l2"
                      else dots)
            scores = torch.where(ids == sentinel, NEG_INF, scores)
            safe_ids = torch.where(ids == sentinel, -1, ids)
        with device_span("ivf.merge"):
            all_scores = torch.cat([best_scores, scores], dim=1)
            all_ids = torch.cat([best_ids, safe_ids], dim=1)
            best_scores, pos = topk_stable(all_scores, k)
            best_ids = torch.gather(all_ids, 1, pos)
    return best_scores, best_ids


ivf_search.rows = 0
ivf_search.traced_queries = 0
ivf_search.paths = {"kernel": 0, "torch": 0}


def _count_rows(probe, bucket_live) -> None:
    """While tracing, add the live rows of the probed buckets (summed on
    the device) to `ivf_search.rows` and the queries to
    `ivf_search.traced_queries`."""
    if tracing():
        _cuda.count_work(ivf_search, rows=bucket_live[probe].sum(),
                         traced_queries=probe.shape[0])


def _scan_chunk(nprobe: int, cap: int, k: int) -> int:
    """Queries a chunk of `_kernel_scan`: their dots and select buffers
    stay within `_PLAIN_CHUNK` elements."""
    from leann_tpu_torch.ops.bucket_kernels import _PLAIN_CHUNK
    from leann_tpu_torch.ops.ivf_topc import buffers

    return max(1, _PLAIN_CHUNK // (nprobe * cap + buffers(k)[1]))


def _scan_dots(queries, probe, bucket_vecs):
    """(the probes as int32, B4's dots [P, b, cap] of `queries` over
    them)."""
    from leann_tpu_torch.ops.bucket_kernels import ivf_bucket_dots

    pr = probe.to(torch.int32)
    return pr, ivf_bucket_dots(queries, pr, bucket_vecs)


def _kernel_scan(queries, probe, bucket_ids, bucket_vecs, bucket_sq,
                 k: int, metric: str, sentinel: int):
    """`ivf_search`'s stage 1 on CUDA tensors (on CPU tensors it runs the
    plain versions of both kernels): B4's dots [P, b, cap] under
    `ivf.scan`, then `ivf_topc` under `ivf.merge`, in chunks of b queries
    whose dots and select buffers stay within `_PLAIN_CHUNK` elements (one
    chunk at the IVF benchmark cell; a search that probes every bucket, as
    `calibrate_nprobe`'s oracle does, takes several). One query's dots are
    smaller than the bucket table, so memory stays bounded at any
    nprobe."""
    from leann_tpu_torch.ops.ivf_topc import ivf_topc

    b, nprobe = probe.shape
    chunk = _scan_chunk(nprobe, bucket_ids.shape[1], k)
    parts = []
    for s in range(0, b, chunk):
        pr, dots = _stage("ivf.scan", lambda: _scan_dots(
            queries[s : s + chunk], probe[s : s + chunk], bucket_vecs))
        parts.append(_stage("ivf.merge", lambda: ivf_topc(
            dots, pr, bucket_sq, bucket_ids, k, metric, sentinel)))
        del dots
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))
