"""`search` — query pipeline (port of `leann_tpu/cli/search_cmd.py`;
reference `src/cli/search.rs:73-257`) over the port's `Index` on
`args.device`: meta-driven provider, query-prefix resolution, filter
parse, auto-hybrid for short queries, BM25 expansion, pruned->recompute
path, text/JSON out."""

from __future__ import annotations

import json
import os
import sys

from leann_tpu_torch.store.locate import find_index, index_base


def add_parser(sub):
    p = sub.add_parser("search", help="Search documents in an index")
    p.add_argument("query")
    p.add_argument("-i", "--index", default=None,
                   help="Index name (default: current directory name)")
    p.add_argument("--top-k", type=int, default=5)
    p.add_argument("--complexity", type=int, default=64)
    p.add_argument("--show-metadata", action="store_true")
    p.add_argument("-f", "--filter", default=None,
                   help='Metadata filter, e.g. "source:*.rs" or "type=code"')
    p.add_argument("--hybrid", action="store_true",
                   help="Force hybrid (vector + BM25) search")
    p.add_argument("--no-auto-hybrid", action="store_true",
                   help="Disable auto-hybrid for short (<=3 word) queries")
    p.add_argument("--no-expand", action="store_true",
                   help="Disable BM25 query expansion for short queries")
    p.add_argument("--hybrid-alpha", type=float, default=0.7)
    p.add_argument("--format", default="text", choices=["text", "json"])
    p.add_argument("--embedding-api-key", default=os.environ.get("OPENAI_API_KEY"))
    p.add_argument("--embedding-api-base", default=os.environ.get("OPENAI_BASE_URL"))
    p.add_argument("--embedding-host", default=os.environ.get("OLLAMA_HOST"))
    p.add_argument("--query-prompt-template", default=None)
    p.add_argument("--sharded", action="store_true",
                   help="Shard the corpus across the --device list (exact "
                        "search over the device mesh)")
    p.set_defaults(func=run)


def run(args) -> int:
    from leann_tpu_torch.api import Index

    index_name = args.index or os.path.basename(os.getcwd())
    try:
        index_dir = find_index(index_name)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 1
    idx = Index(
        index_base(index_dir),
        sharded=args.sharded,
        api_key=args.embedding_api_key,
        host=args.embedding_host,
        base_url=args.embedding_api_base,
        query_template=args.query_prompt_template,
        device=args.device,
    )
    hybrid = True if args.hybrid else (None if not args.no_auto_hybrid else False)
    results = idx.search(
        args.query,
        top_k=args.top_k,
        complexity=args.complexity,
        filter=args.filter,
        hybrid=hybrid,
        hybrid_alpha=args.hybrid_alpha,
        expand=not args.no_expand,
        on_expand=lambda q: print(f"(expanded: {q})", file=sys.stderr),
    )

    if args.format == "json":
        print(json.dumps(
            [
                {
                    "id": r.id,
                    "score": r.score,
                    "text": r.text,
                    "metadata": r.metadata,
                }
                for r in results
            ],
            indent=2,
        ))
    else:
        if not results:
            print("No results.")
        for i, r in enumerate(results):
            print(f"[{i + 1}] score={r.score:.4f}  {r.id}")
            text = r.text if len(r.text) <= 400 else r.text[:400] + "..."
            print(f"    {text}")
            if args.show_metadata and r.metadata:
                print(f"    metadata: {json.dumps(r.metadata)}")
    return 0
