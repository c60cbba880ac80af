"""`build` — end-to-end index construction (port of
`leann_tpu/cli/build_cmd.py`; reference `src/cli/build.rs:126-411`):
walk files, chunk, embed in batches, stream to disk, build the ANN
structure on `args.device`, report stats."""

from __future__ import annotations

import os
import shutil
import sys
import time
from collections import defaultdict
from typing import List

from leann_tpu_torch.chunker import ChunkingStrategy, SmartChunker
from leann_tpu_torch.cli.common import (
    collect_file_paths,
    load_file_content,
    make_provider,
)
from leann_tpu_torch.cli.main import primary_device
from leann_tpu_torch.config import Config
from leann_tpu_torch.index.builder import StreamingIndexBuilder
from leann_tpu_torch.store.locate import index_base, local_index_dir
from leann_tpu_torch.store.passages import Passage


def add_parser(sub):
    p = sub.add_parser("build", help="Build a document index")
    p.add_argument("index_name", nargs="?", default=None,
                   help="Index name (default: current directory name)")
    p.add_argument("--docs", nargs="+", default=["."],
                   help="Document directories and/or files")
    p.add_argument("--backend-name", default="hnsw",
                   choices=["hnsw", "diskann", "flat", "vamana", "ivf"],
                   help="ANN backend: flat (exact), vamana (graph; hnsw/diskann aliases), ivf (partitioned matmul — highest batched QPS)")
    p.add_argument("--metric", default="ip", choices=["ip", "l2", "cosine"])
    p.add_argument("--embedding-model", default="text-embedding-3-small")
    p.add_argument("--embedding-mode", default="openai",
                   choices=["openai", "lmstudio", "ollama", "gemini", "local", "fake"])
    p.add_argument("--embedding-host", default=os.environ.get("OLLAMA_HOST"))
    p.add_argument("--embedding-api-base", default=os.environ.get("OPENAI_BASE_URL"))
    p.add_argument("--embedding-api-key", default=os.environ.get("OPENAI_API_KEY"))
    p.add_argument("--google-api-key", default=os.environ.get("GOOGLE_API_KEY"))
    p.add_argument("--embedding-prompt-template", default=None)
    p.add_argument("--embedding-model-path", default=None)
    p.add_argument("--embedding-dimensions", type=int, default=None,
                   help="Dimensions override (used by the fake embedder)")
    p.add_argument("-f", "--force", action="store_true",
                   help="Force rebuild existing index")
    p.add_argument("--resume", action="store_true",
                   help="Resume an interrupted build from its checkpoint")
    p.add_argument("--recompute", action="store_true",
                   help="Enable recomputation mode (embeddings become prunable)")
    p.add_argument("--graph-degree", type=int, default=32)
    p.add_argument("--complexity", type=int, default=64)
    p.add_argument("--alpha", type=float, default=1.2,
                   help="Vamana pruning alpha")
    p.add_argument("--doc-chunk-size", type=int, default=None)
    p.add_argument("--doc-chunk-overlap", type=int, default=None)
    p.add_argument("--file-types", default=None,
                   help="Comma-separated extensions, e.g. '.txt,.md'")
    p.add_argument("--exclude-types", default=None)
    p.add_argument("--include-hidden", action="store_true")
    p.add_argument("--chunking-strategy", default="simple",
                   choices=["simple", "ast", "auto"])
    p.add_argument("--embedding-batch-size", type=int, default=None)
    p.add_argument("--max-files", type=int, default=None)
    p.add_argument("--max-file-size-kb", type=int, default=None)
    p.add_argument("--no-bm25", action="store_true",
                   help="Skip the BM25 sidecar (disables hybrid search)")
    p.set_defaults(func=run)


def run(args) -> int:
    cfg = Config.load()
    index_name = args.index_name or os.path.basename(os.getcwd()) or "index"
    device = primary_device(args.device)

    index_dir = os.path.join(local_index_dir(), index_name)
    base = index_base(index_dir)
    from leann_tpu_torch.index.builder import ckpt_path

    resuming = args.resume and os.path.exists(ckpt_path(base))
    if os.path.exists(index_dir) and not resuming:
        if not args.force:
            print(
                f"Index '{index_name}' already exists. Use --force to rebuild "
                "(or --resume to continue an interrupted build).",
                file=sys.stderr,
            )
            return 1
        shutil.rmtree(index_dir)
    os.makedirs(index_dir, exist_ok=True)

    chunk_size = args.doc_chunk_size or cfg.build.chunk_size
    chunk_overlap = (
        args.doc_chunk_overlap
        if args.doc_chunk_overlap is not None
        else cfg.build.chunk_overlap
    )
    max_kb = args.max_file_size_kb or cfg.build.max_file_size_kb
    file_types = (
        [s.strip() for s in args.file_types.split(",") if s.strip()]
        if args.file_types
        else cfg.build.file_types
    )
    exclude_types = (
        [s.strip() for s in args.exclude_types.split(",") if s.strip()]
        if args.exclude_types
        else cfg.build.exclude_types
    )

    provider = make_provider(
        args.embedding_mode,
        args.embedding_model,
        config=cfg,
        host=args.embedding_host,
        base_url=args.embedding_api_base,
        api_key=args.embedding_api_key or args.google_api_key,
        model_path=args.embedding_model_path,
        batch_size=args.embedding_batch_size,
        dimensions=args.embedding_dimensions,
        device=device,
    )
    doc_template = (
        args.embedding_prompt_template
        if args.embedding_prompt_template is not None
        else provider.document_prefix()
    )

    print(f"Building index '{index_name}' ({provider.mode}/{provider.model})")
    files = collect_file_paths(
        args.docs, file_types, exclude_types, args.include_hidden,
        args.max_files, max_kb,
    )
    if not files:
        print("No files found to index.", file=sys.stderr)
        shutil.rmtree(index_dir, ignore_errors=True)
        return 1
    print(f"Found {len(files)} files")

    chunker = SmartChunker(
        chunk_size, chunk_overlap, ChunkingStrategy.parse(args.chunking_strategy)
    )
    # Local-mode recompute indexes persist pre-tokenized passages for
    # traversal-time re-embedding on the device.
    tokenizer_encoder = None
    if args.recompute and provider.mode == "local":
        tokenizer_encoder = provider._impl.encoder

    builder = StreamingIndexBuilder(
        base,
        dim=provider.dimensions,
        backend=args.backend_name,
        metric=args.metric,
        embedding_model=provider.model,
        embedding_mode=provider.mode,
        embedding_options=_embedding_options(args, provider),
        is_recompute=args.recompute,
        build_bm25=not args.no_bm25,
        tokenizer_encoder=tokenizer_encoder,
        resume=resuming,
        device=device,
    )
    if resuming:
        print(f"Resuming build: {len(builder)} chunks already embedded "
              f"({builder.files_done} files done)")

    batch_size = args.embedding_batch_size or (
        32 if provider.mode == "ollama" else 100
    )
    ext_stats: dict = defaultdict(int)
    pending: List[Passage] = []
    embed_time = 0.0
    t_start = time.time()

    def flush():
        nonlocal embed_time
        if not pending:
            return
        t0 = time.time()
        vecs = provider.embed_with_template(
            [p.text for p in pending], doc_template
        )
        embed_time += time.time() - t0
        builder.add_batch(pending, vecs)
        pending.clear()

    CHECKPOINT_EVERY = 25  # files between resume checkpoints
    for file_idx, path in enumerate(files):
        if file_idx < builder.files_done:
            continue  # already ingested before the interruption
        content = load_file_content(path)
        if content is None:
            continue
        chunks = chunker.chunk(content, path)
        ext_stats[os.path.splitext(path)[1] or "(none)"] += len(chunks)
        for c in chunks:
            if resuming and builder.has_id(c.id):
                continue
            pending.append(Passage(id=c.id, text=c.text, metadata=c.metadata))
            if len(pending) >= batch_size:
                flush()
        if (file_idx + 1) % CHECKPOINT_EVERY == 0:
            flush()
            builder.checkpoint(file_idx + 1)
    flush()

    if len(builder) == 0:
        print("No chunks produced; nothing to index.", file=sys.stderr)
        shutil.rmtree(index_dir, ignore_errors=True)
        return 1

    print(f"Embedded {len(builder)} chunks; building {builder.backend} index...")
    t0 = time.time()
    meta = builder.build(
        graph_degree=args.graph_degree,
        complexity=args.complexity,
        alpha=args.alpha,
    )
    build_time = time.time() - t0
    total = time.time() - t_start

    print(f"\nIndex '{index_name}' built: {meta.passage_count} passages, "
          f"{meta.dimensions}d, backend={meta.backend_name}")
    for ext, count in sorted(ext_stats.items(), key=lambda kv: -kv[1]):
        print(f"  {ext:>8}: {count} chunks")
    if total > 0:
        print(f"Total {total:.1f}s  (embedding {embed_time:.1f}s = "
              f"{100 * embed_time / total:.0f}%, ann build {build_time:.1f}s, "
              f"{meta.passage_count / total:.0f} chunks/s)")
    return 0


def _embedding_options(args, provider) -> dict:
    opts = {}
    if args.embedding_host:
        opts["host"] = args.embedding_host
    if args.embedding_api_base:
        opts["base_url"] = args.embedding_api_base
    if args.embedding_model_path:
        opts["model_path"] = args.embedding_model_path
    # Persist the resolved templates under the reference's keys
    # (build.rs:344-352): search reads query_prompt_template, and
    # update/recompute re-embed with the stored build_prompt_template —
    # so a custom template never causes an embedding-space mismatch.
    doc_template = (
        args.embedding_prompt_template
        if args.embedding_prompt_template is not None
        else provider.document_prefix()
    ) or ""
    query_prefix = provider.query_prefix() or ""
    if doc_template or query_prefix:
        opts["build_prompt_template"] = doc_template
        opts["query_prompt_template"] = query_prefix
    return opts or None
