"""CLI entry point: `leann-tpu-torch` / `python -m leann_tpu_torch`
(port of `leann_tpu/cli/main.py`).

The same twelve subcommands as the reference (build, update, reindex,
search, ask, react, serve, list, remove, prune, config, mcp) and global
-v/--verbose and -q/--quiet, plus the port's one global option,
`--device`: one device (`cuda`, `cuda:1`, `cpu`) or a comma-separated
list, default `$LEANN_TORCH_DEVICE`, else None, which means `cuda`. It is
parsed once into `args.device` (None, a string, or a list; a list lays
`--sharded`'s mesh, and everything else runs on its first device) and
handed on to every index, searcher, builder, provider and engine the
command opens. A command that reaches the device checks it first: without
CUDA, and without `--device cpu`, it prints `resolve_device`'s message
and returns 1, having run nothing.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Union

from leann_tpu_torch.version import __version__

DeviceArg = Union[None, str, List[str]]


def parse_device(value: Optional[str]) -> DeviceArg:
    """'' / None -> None; 'a,b' -> ['a', 'b']; 'a' -> 'a'."""
    if not value or not value.strip():
        return None
    parts = [p.strip() for p in value.split(",") if p.strip()]
    return parts if len(parts) > 1 else parts[0]


def primary_device(device: DeviceArg):
    """The one device of everything but a sharded mesh."""
    return device[0] if isinstance(device, list) else device


def check_device(device: DeviceArg) -> Optional[str]:
    """None when every listed device resolves, else the error message."""
    from leann_tpu_torch.device import resolve_device

    for d in device if isinstance(device, list) else [device]:
        try:
            resolve_device(d)
        except (RuntimeError, ValueError) as e:
            return str(e)
    return None


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="leann-tpu-torch",
        description="LEANN on PyTorch/CUDA — vector database for RAG",
    )
    parser.add_argument("--version", action="version",
                        version=f"leann-tpu-torch {__version__}")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="Enable verbose output")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="Suppress non-essential output")
    parser.add_argument(
        "--device", type=parse_device,
        default=os.environ.get("LEANN_TORCH_DEVICE"),
        help="Device: cuda (default), cuda:N, cpu, or a comma-separated "
             "list (the mesh of --sharded); default $LEANN_TORCH_DEVICE")
    sub = parser.add_subparsers(dest="command", required=True)

    from leann_tpu_torch.cli import (
        ask_cmd,
        build_cmd,
        config_cmd,
        list_cmd,
        mcp_cmd,
        prune_cmd,
        react_cmd,
        reindex_cmd,
        remove_cmd,
        search_cmd,
        serve_cmd,
        update_cmd,
    )

    for mod in (
        build_cmd, update_cmd, reindex_cmd, search_cmd, ask_cmd, react_cmd,
        serve_cmd, list_cmd, remove_cmd, prune_cmd, config_cmd, mcp_cmd,
    ):
        mod.add_parser(sub)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    from leann_tpu_torch.utils import configure_logging

    configure_logging(verbose=args.verbose, quiet=args.quiet)
    if getattr(args, "uses_device", True):
        err = check_device(args.device)
        if err is not None:
            print(err, file=sys.stderr)
            return 1
    try:
        return args.func(args)
    except KeyboardInterrupt:
        print("\nInterrupted.", file=sys.stderr)
        return 130
    except BrokenPipeError:
        # stdout consumer (e.g. `| head`) closed early: exit quietly
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
