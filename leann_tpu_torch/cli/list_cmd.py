"""`list` — enumerate local + global indexes with status and sizes
(port of `leann_tpu/cli/list_cmd.py`; reference `src/cli/list.rs:16-125`).
Host only: no device."""

from __future__ import annotations

import os

from leann_tpu_torch.store.locate import BASE_NAME, list_indexes
from leann_tpu_torch.store.meta import IndexMeta


def add_parser(sub):
    p = sub.add_parser("list", help="List all indexes")
    p.add_argument("--detailed", action="store_true")
    p.set_defaults(func=run, uses_device=False)


def _dir_size(path: str) -> int:
    total = 0
    for dirpath, _, filenames in os.walk(path):
        for f in filenames:
            try:
                total += os.path.getsize(os.path.join(dirpath, f))
            except OSError:
                pass
    return total


def _fmt_size(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024:
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n:.1f}TB"


def run(args) -> int:
    entries = list_indexes()
    if not entries:
        print("No indexes found. Build one with: leann-tpu-torch build <name> --docs <dir>")
        return 0
    for name, path, scope in entries:
        meta_file = os.path.join(path, BASE_NAME + ".meta.json")
        if os.path.exists(meta_file):
            meta = IndexMeta.load(meta_file)
            status = "OK"
            detail = (
                f"{meta.passage_count} passages, {meta.dimensions}d, "
                f"{meta.backend_name}"
            )
            if meta.is_pruned:
                detail += ", pruned"
        else:
            status = "INCOMPLETE"
            detail = ""
        size = _fmt_size(_dir_size(path))
        print(f"{name:<24} [{scope}] {status:<10} {size:>10}  {detail}")
        if args.detailed and os.path.exists(meta_file):
            for fname in sorted(os.listdir(path)):
                fp = os.path.join(path, fname)
                print(f"    {fname:<44} {_fmt_size(os.path.getsize(fp)):>10}")
    return 0
