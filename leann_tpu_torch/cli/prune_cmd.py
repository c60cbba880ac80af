"""`prune` — delete stored embeddings, flip meta.is_pruned, report MB
saved (port of `leann_tpu/cli/prune_cmd.py`; reference
`src/cli/prune.rs:17-79`). Search then runs in recompute mode — LEANN's
signature storage/compute tradeoff. Host only: no device."""

from __future__ import annotations

import sys

from leann_tpu_torch.store.embeddings import prune_embeddings
from leann_tpu_torch.store.locate import find_index, index_base
from leann_tpu_torch.store.meta import IndexMeta, meta_path


def add_parser(sub):
    p = sub.add_parser(
        "prune", help="Prune embeddings to enable recomputation mode"
    )
    p.add_argument("index_name")
    p.add_argument("-y", "--yes", action="store_true")
    p.set_defaults(func=run, uses_device=False)


def run(args) -> int:
    try:
        index_dir = find_index(args.index_name)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 1
    base = index_base(index_dir)
    meta = IndexMeta.load(meta_path(base))
    if meta.is_pruned:
        print("Index is already pruned.")
        return 0
    if not args.yes:
        try:
            answer = input(
                "Pruning deletes stored embeddings; searches will re-embed "
                "passages on demand. Continue? [y/N] "
            )
        except (EOFError, KeyboardInterrupt):
            print("\nAborted.")
            return 1
        if answer.strip().lower() not in ("y", "yes"):
            print("Aborted.")
            return 1
    freed = prune_embeddings(base)
    meta.is_pruned = True
    meta.save(meta_path(base))
    mb = (freed or 0) / (1024 * 1024)
    print(f"Pruned '{args.index_name}': {mb:.1f} MB freed.")
    return 0
