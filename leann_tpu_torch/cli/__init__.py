"""Command-line surface (port of `leann_tpu/cli/`): the reference's 11
subcommands (`src/cli/mod.rs:49-84`) — build, update, search, ask,
react, serve, list, remove, prune, config, mcp — plus reindex, on
argparse, with one global `--device` for every command that reaches the
device."""
