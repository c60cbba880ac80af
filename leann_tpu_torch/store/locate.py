"""Index directory resolution.

Resolution order mirrors the reference (`src/index/locate.rs:11-36`):
  1. `./.leann/indexes/<name>`
  2. `<name>` as a literal path (absolute or relative dir)
  3. `~/.leann/indexes/<name>`
An index dir holds files with base name `documents.leann`
(reference `src/cli/build.rs:140`).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

BASE_NAME = "documents.leann"


def local_index_dir(cwd: Optional[str] = None) -> str:
    return os.path.join(cwd or os.getcwd(), ".leann", "indexes")


def global_index_dir() -> str:
    return os.path.join(os.path.expanduser("~"), ".leann", "indexes")


def index_base(index_dir: str) -> str:
    return os.path.join(index_dir, BASE_NAME)


def find_index(name: str, cwd: Optional[str] = None) -> str:
    """Return the index *directory* for `name`, raising if absent."""
    candidates = [
        os.path.join(local_index_dir(cwd), name),
        name,
        os.path.join(global_index_dir(), name),
    ]
    for cand in candidates:
        if os.path.isdir(cand) and os.path.exists(
            os.path.join(cand, BASE_NAME + ".meta.json")
        ):
            return cand
    raise FileNotFoundError(
        f"Index '{name}' not found. Looked in: {', '.join(candidates)}. "
        f"Build one with: leann-tpu build {name} --docs <dir>"
    )


def list_indexes(cwd: Optional[str] = None) -> List[Tuple[str, str, str]]:
    """All (name, dir, scope) pairs across local + global locations."""
    out = []
    for scope, root in (("local", local_index_dir(cwd)), ("global", global_index_dir())):
        if not os.path.isdir(root):
            continue
        for name in sorted(os.listdir(root)):
            d = os.path.join(root, name)
            if os.path.isdir(d):
                out.append((name, d, scope))
    return out
