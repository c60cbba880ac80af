"""HTTP API server on stdlib ThreadingHTTPServer (port of
`leann_tpu/server/http.py`; routes, JSON bodies and status codes are the
reference's).

Route parity with the reference's axum server (`src/cli/serve.rs:90-96`):
  GET  /          service info
  GET  /health    "ok"
  GET  /indexes   enumerate available indexes
  GET  /info      loaded-index metadata
  POST /search    {query, top_k?, complexity?, filter?, hybrid?} -> results
                  with took_ms (serve.rs:294)
Like the reference, the searcher + provider load once and are shared
across requests (serve.rs:82-87); unlike the CLI path which reloads per
invocation. Optional permissive CORS via --cors.

Unlike the reference, concurrent requests are micro-batched: each request
enqueues into a MicroBatcher which coalesces everything that arrives
within a ~2ms window into ONE embed call and ONE device search — the
serving path keeps the engines' batch shape instead of paying a full
dispatch per query. `POST /search` also accepts `queries: [...]` for an
explicit batch.
"""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from leann_tpu_torch.index.filter import MetadataFilter
from leann_tpu_torch.index.searcher import IndexSearcher, SearchOptions
from leann_tpu_torch.server.batching import MicroBatcher
from leann_tpu_torch.store.locate import list_indexes
from leann_tpu_torch.version import __version__


class ServerState:
    def __init__(
        self,
        searcher: IndexSearcher,
        provider,
        query_template,
        index_name,
        max_batch: int = 64,
        batch_window_ms: float = 2.0,
    ):
        self.searcher = searcher
        self.provider = provider
        self.query_template = query_template
        self.index_name = index_name
        self.batcher = MicroBatcher(
            searcher, provider, query_template,
            max_batch=max_batch, window_ms=batch_window_ms,
        )

    def warm(self, top_ks=(10,), max_batch: Optional[int] = None) -> int:
        """Warm the serving path: one search per (pow-2 batch bucket,
        top_k), the reference's lattice. PyTorch has no jit cache to
        fill; what a warm search buys on the card is the first launch
        of each kernel the path runs (the CUDA module load; on a fresh
        checkout the nvcc build of the kernel library), the first cuBLAS
        handle and the caching allocator's first blocks, which the first
        flush of live traffic would pay otherwise. Returns the number of
        searches issued."""
        import numpy as np

        from leann_tpu_torch.index.searcher import SearchOptions

        # pruned (recompute-mode) indexes are guarded here, not in each
        # caller: a warm-up "search" would run full re-embedding
        # traversals per bucket on the device (minutes, and the
        # traversal's work is shaped by real frontier contents, so a
        # zero-vector warmup would not warm the right shapes)
        if getattr(self.searcher.meta, "is_pruned", False):
            return 0
        mb = max_batch or self.batcher.max_batch
        dim = self.searcher.meta.dimensions
        n = 0
        for top_k in top_ks:
            b = 1
            while True:
                q = np.zeros((b, dim), dtype=np.float32)
                self.searcher.search(q, SearchOptions(top_k=top_k))
                n += 1
                # a non-pow-2 max_batch (e.g. 48) still pads its top
                # flushes to the NEXT pow-2 bucket (64), so keep going
                # until the bucket covers mb, not until b == mb
                if b >= mb:
                    break
                b *= 2
        return n


def make_handler(state: ServerState, cors: bool):
    class Handler(BaseHTTPRequestHandler):
        server_version = f"leann-tpu/{__version__}"
        # HTTP/1.1 keep-alive: without it BaseHTTPRequestHandler speaks
        # HTTP/1.0 and closes after every response, so clients reusing
        # connections desync (and every request pays a TCP setup). The
        # reference's axum server is keep-alive HTTP/1.1 (serve.rs:90).
        protocol_version = "HTTP/1.1"
        # headers and body go out in separate send()s; with Nagle on,
        # keep-alive connections stall per response waiting for the
        # peer's delayed ACK
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # route through stdout quietly
            pass

        def _send(self, code: int, payload) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if cors:
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Access-Control-Allow-Headers", "Content-Type")
                self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
            self.end_headers()
            self.wfile.write(body)

        def do_OPTIONS(self):
            self._send(204, {})

        def do_GET(self):
            if self.path == "/" :
                self._send(200, {
                    "service": "leann-tpu",
                    "version": __version__,
                    "index": state.index_name,
                    "endpoints": ["/health", "/indexes", "/info", "/search", "/metrics"],
                })
            elif self.path == "/health":
                self._send(200, {"status": "ok"})
            elif self.path == "/metrics":
                from leann_tpu_torch.utils import METRICS

                body = METRICS.prometheus().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/indexes":
                self._send(200, {
                    "indexes": [
                        {"name": name, "scope": scope, "path": path}
                        for name, path, scope in list_indexes()
                    ]
                })
            elif self.path == "/info":
                meta = state.searcher.meta
                self._send(200, {
                    "index": state.index_name,
                    "backend": meta.backend_name,
                    "embedding_model": meta.embedding_model,
                    "embedding_mode": meta.embedding_mode,
                    "dimensions": meta.dimensions,
                    "passage_count": meta.passage_count,
                    "metric": meta.metric,
                    "is_pruned": meta.is_pruned,
                })
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/search":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._send(400, {"error": "invalid JSON body"})
                return
            query = req.get("query")
            queries = req.get("queries")
            if queries is not None:
                if not isinstance(queries, list) or not all(
                    isinstance(s, str) and s for s in queries
                ):
                    self._send(400, {"error": "queries must be a list of strings"})
                    return
            elif not query or not isinstance(query, str):
                self._send(400, {"error": "missing required field: query"})
                return
            top_k = int(req.get("top_k", 5))
            complexity = int(req.get("complexity", 64))
            filt: Optional[MetadataFilter] = None
            if req.get("filter"):
                filt = MetadataFilter.parse(str(req["filter"]))
            t0 = time.time()

            def fmt(rows):
                return [
                    {
                        "id": r.id,
                        "score": r.score,
                        "text": r.text,
                        "metadata": r.metadata,
                    }
                    for r in rows
                ]

            try:
                if queries is not None:
                    hybrid = bool(req.get("hybrid", False))
                    alpha = float(req.get("hybrid_alpha", 0.7))
                    if hybrid:
                        # hybrid needs per-query BM25 text: route each
                        # query through the standard path with its own
                        # query_text (coalescing is lost, correctness
                        # isn't — hybrid was silently ignored before)
                        per_query = [
                            state.batcher.submit(
                                qt,
                                SearchOptions(
                                    top_k=top_k,
                                    complexity=complexity,
                                    filter=filt,
                                    hybrid=True,
                                    hybrid_alpha=alpha,
                                    query_text=qt,
                                ),
                            )
                            for qt in queries
                        ]
                        took_ms = int((time.time() - t0) * 1000)
                        self._send(200, {
                            "results_per_query": [
                                fmt(rows) for rows in per_query
                            ],
                            "took_ms": took_ms,
                        })
                        return
                    opts = SearchOptions(
                        top_k=top_k,
                        complexity=complexity,
                        filter=filt,
                        hybrid=False,
                        hybrid_alpha=alpha,
                    )
                    per_query = state.batcher.submit_many(queries, opts)
                    took_ms = int((time.time() - t0) * 1000)
                    self._send(200, {
                        "results_per_query": [fmt(rows) for rows in per_query],
                        "took_ms": took_ms,
                    })
                    return
                results = state.batcher.submit(
                    query,
                    SearchOptions(
                        top_k=top_k,
                        complexity=complexity,
                        filter=filt,
                        hybrid=bool(req.get("hybrid", False)),
                        hybrid_alpha=float(req.get("hybrid_alpha", 0.7)),
                        query_text=query,
                    ),
                )
            except Exception as e:
                self._send(500, {"error": str(e)})
                return
            took_ms = int((time.time() - t0) * 1000)
            self._send(200, {
                "results": fmt(results),
                "took_ms": took_ms,
            })

    return Handler


class _LeannHTTPServer(ThreadingHTTPServer):
    # socketserver's default listen backlog is 5; a client fleet opening
    # its connections simultaneously (every benchmark phase start, any
    # load-balancer health-check burst) overflows it and the kernel
    # RSTs the overflow. 128 matches what production WSGI servers
    # request.
    request_queue_size = 128
    daemon_threads = True


def serve(
    state: ServerState, host: str = "127.0.0.1", port: int = 3000,
    cors: bool = False,
) -> ThreadingHTTPServer:
    server = _LeannHTTPServer((host, port), make_handler(state, cors))
    return server
