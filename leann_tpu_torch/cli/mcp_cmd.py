"""`mcp` — MCP stdio server for agent integration (port of
`leann_tpu/cli/mcp_cmd.py`; reference `src/cli/mcp.rs:296-319`),
searching on `args.device`."""

from __future__ import annotations

from leann_tpu_torch.cli.main import primary_device
from leann_tpu_torch.server.mcp import McpServer


def add_parser(sub):
    p = sub.add_parser("mcp", help="Start MCP server (stdio)")
    p.add_argument("-i", "--index", default=None,
                   help="Default index name for the search tool")
    p.set_defaults(func=run)


def run(args) -> int:
    McpServer(default_index=args.index,
              device=primary_device(args.device)).run_stdio()
    return 0
