"""`remove` — delete an index dir, type-name-to-confirm, local/global
disambiguation (port of `leann_tpu/cli/remove_cmd.py`; reference
`src/cli/remove.rs:17-108`). Host only: no device."""

from __future__ import annotations

import os
import shutil
import sys

from leann_tpu_torch.store.locate import global_index_dir, local_index_dir


def add_parser(sub):
    p = sub.add_parser("remove", help="Remove an index")
    p.add_argument("index_name")
    p.add_argument("-y", "--yes", action="store_true", help="Skip confirmation")
    p.add_argument("--scope", choices=["local", "global"], default=None,
                   help="Disambiguate when the name exists in both scopes")
    p.set_defaults(func=run, uses_device=False)


def run(args) -> int:
    candidates = []
    local = os.path.join(local_index_dir(), args.index_name)
    glob = os.path.join(global_index_dir(), args.index_name)
    if os.path.isdir(local):
        candidates.append(("local", local))
    if os.path.isdir(glob):
        candidates.append(("global", glob))
    if not candidates:
        print(f"Index '{args.index_name}' not found.", file=sys.stderr)
        return 1
    if len(candidates) > 1:
        if args.scope is None:
            print(
                f"Index '{args.index_name}' exists in both scopes; "
                "pass --scope local or --scope global.",
                file=sys.stderr,
            )
            return 1
        candidates = [c for c in candidates if c[0] == args.scope]
    scope, path = candidates[0]
    if not args.yes:
        try:
            answer = input(
                f"Type the index name to confirm removing {scope} index "
                f"'{args.index_name}': "
            )
        except (EOFError, KeyboardInterrupt):
            print("\nAborted.")
            return 1
        if answer.strip() != args.index_name:
            print("Name mismatch; aborted.", file=sys.stderr)
            return 1
    shutil.rmtree(path)
    print(f"Removed {scope} index '{args.index_name}'.")
    return 0
