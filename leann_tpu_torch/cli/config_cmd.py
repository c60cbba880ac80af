"""`config` — show / init / path subcommands (port of
`leann_tpu/cli/config_cmd.py`; reference `src/cli/config_cmd.rs:14-101`;
api_key is masked on show). Host only: no device."""

from __future__ import annotations

import os

from leann_tpu_torch.config import Config, EXAMPLE_CONFIG


def add_parser(sub):
    p = sub.add_parser("config", help="Manage configuration")
    ssub = p.add_subparsers(dest="config_action", required=True)
    ssub.add_parser("show", help="Show current configuration")
    ssub.add_parser("init", help="Write an example config file")
    ssub.add_parser("path", help="Print the config file path")
    p.set_defaults(func=run, uses_device=False)


def run(args) -> int:
    path = Config.config_path()
    if args.config_action == "path":
        print(path)
        return 0
    if args.config_action == "init":
        if os.path.exists(path):
            print(f"Config already exists at {path}")
            return 1
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(EXAMPLE_CONFIG)
        print(f"Wrote example config to {path}")
        return 0
    # show
    cfg = Config.load()
    exists = os.path.exists(path)
    print(f"Config file: {path} ({'present' if exists else 'absent, using defaults'})")
    print("\n[embedding]")
    for key, val in vars(cfg.embedding).items():
        if key == "api_key" and val:
            val = val[:4] + "..." + val[-2:] if len(val) > 8 else "***"
        print(f"  {key} = {val!r}")
    print("\n[build]")
    for key, val in vars(cfg.build).items():
        print(f"  {key} = {val!r}")
    return 0
