"""Server-side micro-batching: coalesce concurrent requests into one
device batch (port of `leann_tpu/server/batching.py`).

The engines are batched ([B, D] in, [B, k] out) but HTTP requests arrive
one query at a time; without coalescing every request pays a full device
launch and the batched engine's advantage evaporates at the serving
boundary (the reference has the same shape: one embed + one search per
request, `src/cli/serve.rs:260-311`). The batcher holds each request for at most
`window_ms` after the first enqueue (or until `max_batch` requests are
waiting), embeds all pending query texts in ONE provider call, runs ONE
engine search per options-group, and hands each caller its own rows.

Requests group by the parts of their search options that change the
DEVICE program (top_k, complexity, filter); plain and hybrid requests
with matching knobs share one group — hybrid rescoring is host-side and
per-row (`SearchOptions.query_texts`). A production mix of plain +
hybrid traffic therefore costs one device dispatch per flush.

Threads and the device: the two flush threads run engine searches
concurrently on one searcher. What they share is safe for that: the
kernel wrappers count launches under a lock (`ops/_cuda.count_launch`),
the engines keep no per-call buffers, the passage store reads with
`pread`, the BM25 sidecar loads once under a lock, and every launch
names its tensors' device (`torch.cuda.device(dev)` around the kernel,
the device's current stream), so an engine on cuda:1 launches on its own
device from a thread whose current device is cuda:0. Both threads use
that device's current stream, so their launches run in order there.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from leann_tpu_torch.index.searcher import SearchOptions


@dataclass
class _Pending:
    query: str
    options: SearchOptions
    key: Tuple
    enqueued: float = 0.0
    done: threading.Event = field(default_factory=threading.Event)
    results: Optional[list] = None
    error: Optional[BaseException] = None


def _options_key(o: SearchOptions) -> Tuple:
    filt = getattr(o.filter, "source", None) if o.filter is not None else None
    if filt is None and o.filter is not None:
        # canonical fallback for programmatic filters without DSL source:
        # the node tree is plain dataclasses (Condition/And/Or), whose
        # reprs are deterministic value reprs — unlike the MetadataFilter
        # wrapper's default object repr (memory address), which would
        # make identical filters never share a batch group
        filt = repr(getattr(o.filter, "node", o.filter.source))
    # NOTE: neither query_text nor the hybrid flag is in the key. The
    # device search (the expensive part) is identical for plain and
    # hybrid requests — only the host-side BM25 rescore differs, and
    # that is per-row via SearchOptions.query_texts (None row = plain).
    # Keying on text/hybrid would make every mix (and every hybrid
    # text) its own device search, serializing the flushes.
    return (o.top_k, o.complexity, o.hybrid_alpha, filt, o.expand)


class MicroBatcher:
    """Owns a worker thread that drains the request queue in flushes.

    submit() blocks the calling (HTTP handler) thread until its rows are
    ready — concurrency comes from ThreadingHTTPServer, throughput from
    the coalesced device batches.
    """

    def __init__(
        self,
        searcher,
        provider,
        query_template: Optional[str],
        max_batch: int = 64,
        window_ms: float = 2.0,
        pipeline_depth: int = 2,
    ):
        self.searcher = searcher
        self.provider = provider
        self.query_template = query_template
        self.max_batch = max(1, int(max_batch))
        self.window_s = max(0.0, float(window_ms)) / 1000.0
        self._queue: List[_Pending] = []
        self._cv = threading.Condition()
        self._closed = False
        # depth-2 flush pipeline: while flush N blocks on its device
        # results + host postprocessing (passage fetch, hybrid merge),
        # flush N+1 embeds and launches — PyTorch launches are
        # asynchronous and the ctypes kernel calls release the GIL, so
        # consecutive device batches overlap the host work instead of
        # serializing behind it
        from concurrent.futures import ThreadPoolExecutor

        depth = max(1, int(pipeline_depth))
        self._pool = ThreadPoolExecutor(
            max_workers=depth, thread_name_prefix="leann-flush",
        )
        # One permit per pipeline slot. Without this gate the collector
        # keeps slicing the queue into new flushes while both slots are
        # busy, so under load the batch train FRAGMENTS: each window's
        # trickle becomes its own queued flush instead of accumulating
        # into the next slot's drain. Blocking collect until a slot
        # frees makes every flush drain the whole backlog.
        self._slots = threading.Semaphore(depth)
        self._worker = threading.Thread(
            target=self._run, name="leann-microbatch", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------- API

    def submit(
        self, query: str, options: SearchOptions, timeout: float = 120.0
    ) -> list:
        item = _Pending(
            query=query, options=options, key=_options_key(options),
            enqueued=time.monotonic(),
        )
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is shut down")
            self._queue.append(item)
            self._cv.notify()
        if not item.done.wait(timeout):
            raise TimeoutError("search timed out in batch queue")
        if item.error is not None:
            raise item.error
        return item.results

    def submit_many(
        self, queries: Sequence[str], options: SearchOptions
    ) -> List[list]:
        """Batch API: embeds + searches the whole list as one unit
        (bypasses the queue window — the caller already batched)."""
        qvecs = self.provider.embed_with_template(
            list(queries), self.query_template
        )
        return self.searcher.search(np.asarray(qvecs), options)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=5)
        self._pool.shutdown(wait=True)

    # ---------------------------------------------------------- worker

    def _run(self) -> None:
        while True:
            self._slots.acquire()  # wait for a free pipeline slot
            batch = self._collect()
            if batch is None:
                self._slots.release()
                return
            if batch:
                self._pool.submit(self._flush_slot, batch)
            else:
                self._slots.release()

    def _flush_slot(self, batch: List[_Pending]) -> None:
        try:
            self._flush(batch)
        finally:
            self._slots.release()

    def _collect(self) -> Optional[List[_Pending]]:
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if not self._queue:
                return None  # closed and drained
            # the window runs from the OLDEST waiting item's enqueue
            # time, not from collect start: a request that already
            # waited out an in-flight flush must not wait another full
            # window on top
            deadline = self._queue[0].enqueued + self.window_s
            while len(self._queue) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
                if self._closed:
                    break
            batch = self._queue[: self.max_batch]
            del self._queue[: self.max_batch]
            return batch

    def _flush(self, batch: List[_Pending]) -> None:
        from leann_tpu_torch.utils import METRICS

        t0 = time.perf_counter()
        try:
            qvecs = self.provider.embed_with_template(
                [p.query for p in batch], self.query_template
            )
            qvecs = np.asarray(qvecs, dtype=np.float32)
        except BaseException as e:  # propagate to every waiter
            for p in batch:
                p.error = e
                p.done.set()
            return
        t1 = time.perf_counter()

        groups: dict = {}
        for i, p in enumerate(batch):
            groups.setdefault(p.key, []).append(i)
        for idxs in groups.values():
            opts = batch[idxs[0]].options
            texts = [
                (batch[i].options.query_text or batch[i].query)
                if batch[i].options.hybrid else None
                for i in idxs
            ]
            if any(t is not None for t in texts):
                from dataclasses import replace

                opts = replace(opts, hybrid=True, query_texts=texts)
            tg = time.perf_counter()
            try:
                rows = self.searcher.search(qvecs[idxs], opts)
            except BaseException as e:
                for i in idxs:
                    batch[i].error = e
                    batch[i].done.set()
                continue
            METRICS.observe("batch.group_ms",
                            (time.perf_counter() - tg) * 1e3)
            for row, i in zip(rows, idxs):
                batch[i].results = row
                batch[i].done.set()
        METRICS.inc("batch.flushes")
        METRICS.inc("batch.rows", len(batch))
        METRICS.observe("batch.flush_size", len(batch))
        METRICS.observe("batch.groups_per_flush", len(groups))
        METRICS.observe("batch.embed_ms", (t1 - t0) * 1e3)
        METRICS.observe("batch.flush_ms", (time.perf_counter() - t0) * 1e3)
        if os.environ.get("LEANN_BATCH_DEBUG"):
            import sys

            print(
                f"[batch] size={len(batch)} groups={len(groups)} "
                f"embed={1e3 * (t1 - t0):.1f}ms "
                f"total={1e3 * (time.perf_counter() - t0):.1f}ms",
                file=sys.stderr, flush=True,
            )
