"""Command-line surface: the reference's 11 subcommands
(`src/cli/mod.rs:49-84`) — build, update, search, ask, react, serve,
list, remove, prune, config, mcp — on argparse."""
