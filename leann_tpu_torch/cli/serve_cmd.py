"""`serve` — HTTP API server (port of `leann_tpu/cli/serve_cmd.py`;
reference `src/cli/serve.rs:32-316`), searching on `args.device` (a
list lays `--sharded`'s mesh)."""

from __future__ import annotations

import os
import sys

from leann_tpu_torch.cli.common import provider_from_meta, resolve_query_template
from leann_tpu_torch.cli.main import primary_device
from leann_tpu_torch.index.searcher import IndexSearcher
from leann_tpu_torch.server.http import ServerState, serve
from leann_tpu_torch.store.locate import find_index, index_base
from leann_tpu_torch.store.meta import IndexMeta, meta_path


class _PrunedAdapter:
    """Serves a pruned (recompute-mode) index behind the IndexSearcher
    search(q, options) interface the HTTP handler expects; the recompute
    searcher is picked as `api.Index` picks it."""

    def __init__(self, base, provider, meta, device=None):
        from leann_tpu_torch.index.recompute import (
            GraphRecomputeSearcher,
            RecomputeSearcher,
        )
        from leann_tpu_torch.store.graphfile import GraphFile
        from leann_tpu_torch.store.tokens import tokens_exist

        self.meta = meta
        if (
            meta.embedding_mode == "local"
            and GraphFile.exists(base)
            and tokens_exist(base)
        ):
            # the provider's encoder was built on the same device
            self._impl = GraphRecomputeSearcher(
                base, provider._impl.encoder, device=device)
            self._graph = True
        else:
            from leann_tpu_torch.cli.common import resolve_build_template

            self._impl = RecomputeSearcher(
                base, provider,
                document_template=resolve_build_template(meta, provider),
                device=device,
            )
            self._graph = False

    def search(self, qvecs, options):
        out = []
        for qv in qvecs:
            if self._graph:
                out.append(self._impl.search(
                    qv, top_k=options.top_k, complexity=options.complexity,
                    filter=options.filter,
                ))
            else:
                out.append(self._impl.search(
                    qv, top_k=options.top_k, filter=options.filter,
                ))
        return out


def add_parser(sub):
    p = sub.add_parser("serve", help="Start HTTP API server")
    p.add_argument("index_name", nargs="?", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=3000)
    p.add_argument("--cors", action="store_true")
    p.add_argument("--embedding-api-key", default=os.environ.get("OPENAI_API_KEY"))
    p.add_argument("--sharded", action="store_true",
                   help="Shard the corpus across the --device list")
    p.add_argument("--max-batch", type=int, default=64,
                   help="Micro-batch size cap for coalesced requests")
    p.add_argument("--batch-window-ms", type=float, default=2.0,
                   help="How long to hold a request waiting for batchmates")
    p.add_argument("--warm", action="store_true",
                   help="Run one search per pow-2 batch bucket before "
                        "accepting traffic, so no request pays a "
                        "kernel's first launch or the first cuBLAS "
                        "handle")
    p.set_defaults(func=run)


def run(args) -> int:
    index_name = args.index_name or os.path.basename(os.getcwd())
    try:
        index_dir = find_index(index_name)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 1
    base = index_base(index_dir)
    meta = IndexMeta.load(meta_path(base))
    device = primary_device(args.device)
    provider = provider_from_meta(meta, api_key=args.embedding_api_key,
                                  device=device)
    template = resolve_query_template(None, meta)
    if meta.is_pruned:
        searcher = _PrunedAdapter(base, provider, meta, device=device)
    else:
        searcher = IndexSearcher.load(
            base, sharded=args.sharded,
            device=args.device if args.sharded else device)
    state = ServerState(
        searcher, provider, template, index_name,
        max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
    )
    if args.warm:
        import time as _time

        t0 = _time.time()
        n = state.warm()  # no-ops (returns 0) for pruned indexes
        if n:
            print(f"Warmed {n} serving programs in {_time.time() - t0:.0f}s")
        else:
            print("--warm skipped: pruned index (recompute programs are "
                  "shaped by live traversal state, not warmable buckets)")
    server = serve(state, host=args.host, port=args.port, cors=args.cors)
    print(f"Serving index '{index_name}' on http://{args.host}:{args.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\nShutting down.")
        server.shutdown()
    return 0
