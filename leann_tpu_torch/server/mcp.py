"""MCP (Model Context Protocol) stdio server (port of
`leann_tpu/server/mcp.py`; tool names, schemas and replies are the
reference's). The searchers it opens run on the server's `device`.

Tool parity with the reference's rmcp server (`src/cli/mcp.rs:105-132`):
tools `search` (markdown-formatted results, filter/hybrid/pruned-recompute
supported) and `list_indexes`. JSON-RPC 2.0 over stdin/stdout; all logs
go to stderr because stdout is the protocol channel (mcp.rs:298-301).
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, Optional

from leann_tpu_torch.version import __version__

PROTOCOL_VERSION = "2024-11-05"

SEARCH_TOOL = {
    "name": "search",
    "description": (
        "Search a LEANN-TPU vector index for passages relevant to a query. "
        "Supports metadata filters and hybrid (vector+BM25) ranking."
    ),
    "inputSchema": {
        "type": "object",
        "properties": {
            "query": {"type": "string", "description": "The search query"},
            "index": {"type": "string", "description": "Index name (optional)"},
            "top_k": {"type": "integer", "default": 5},
            "complexity": {"type": "integer", "default": 64},
            "filter": {
                "type": "string",
                "description": 'Metadata filter, e.g. "source:*.rs"',
            },
            "hybrid": {"type": "boolean", "default": False},
        },
        "required": ["query"],
    },
}

LIST_TOOL = {
    "name": "list_indexes",
    "description": "List all available LEANN-TPU indexes.",
    "inputSchema": {"type": "object", "properties": {}},
}


class McpServer:
    def __init__(self, default_index: Optional[str] = None, device=None):
        """`device` places every searcher and local encoder this server
        opens (None = cuda, as at every entry point of the port)."""
        self.default_index = default_index
        self.device = device
        self._searchers: Dict[str, Any] = {}

    # ---------------- tool implementations ----------------

    def _get_session(self, index_name: Optional[str]):
        import os

        from leann_tpu_torch.cli.common import provider_from_meta, resolve_query_template
        from leann_tpu_torch.index.searcher import IndexSearcher
        from leann_tpu_torch.store.locate import find_index, index_base
        from leann_tpu_torch.store.meta import IndexMeta, meta_path

        name = index_name or self.default_index or os.path.basename(os.getcwd())
        if name not in self._searchers:
            index_dir = find_index(name)
            base = index_base(index_dir)
            meta = IndexMeta.load(meta_path(base))
            provider = provider_from_meta(meta, device=self.device)
            template = resolve_query_template(None, meta)
            if meta.is_pruned:
                from leann_tpu_torch.index.recompute import RecomputeSearcher

                from leann_tpu_torch.cli.common import resolve_build_template

                searcher = RecomputeSearcher(
                    base, provider,
                    document_template=resolve_build_template(meta, provider),
                    device=self.device,
                )
            else:
                searcher = IndexSearcher.load(base, device=self.device)
            self._searchers[name] = (searcher, provider, template, meta)
        return self._searchers[name]

    def do_search(self, args: Dict[str, Any]) -> str:
        from leann_tpu_torch.index.filter import MetadataFilter
        from leann_tpu_torch.index.recompute import RecomputeSearcher
        from leann_tpu_torch.index.searcher import SearchOptions

        query = args["query"]
        top_k = int(args.get("top_k", 5))
        searcher, provider, template, meta = self._get_session(args.get("index"))
        filt = (
            MetadataFilter.parse(str(args["filter"])) if args.get("filter") else None
        )
        qvec = provider.embed_with_template([query], template)
        if isinstance(searcher, RecomputeSearcher):
            results = searcher.search(qvec[0], top_k=top_k, filter=filt)
        else:
            results = searcher.search(
                qvec,
                SearchOptions(
                    top_k=top_k,
                    complexity=int(args.get("complexity", 64)),
                    filter=filt,
                    hybrid=bool(args.get("hybrid", False)),
                    query_text=query,
                ),
            )[0]
        if not results:
            return f"No results for: {query}"
        lines = [f"## Search results for: {query}\n"]
        for i, r in enumerate(results):
            source = r.metadata.get("source", r.id)
            lines.append(f"**[{i + 1}]** `{source}` (score {r.score:.3f})")
            text = r.text if len(r.text) <= 600 else r.text[:600] + "..."
            lines.append(f"> {text}\n")
        return "\n".join(lines)

    def do_list_indexes(self) -> str:
        from leann_tpu_torch.store.locate import list_indexes

        entries = list_indexes()
        if not entries:
            return "No indexes found."
        return "\n".join(
            f"- {name} ({scope}): {path}" for name, path, scope in entries
        )

    # ---------------- JSON-RPC plumbing ----------------

    def handle(self, msg: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        method = msg.get("method", "")
        msg_id = msg.get("id")
        if method == "initialize":
            return self._result(msg_id, {
                "protocolVersion": PROTOCOL_VERSION,
                "capabilities": {"tools": {}},
                "serverInfo": {"name": "leann-tpu", "version": __version__},
            })
        if method in ("notifications/initialized", "initialized"):
            return None
        if method == "ping":
            return self._result(msg_id, {})
        if method == "tools/list":
            return self._result(msg_id, {"tools": [SEARCH_TOOL, LIST_TOOL]})
        if method == "tools/call":
            params = msg.get("params") or {}
            name = params.get("name")
            args = params.get("arguments") or {}
            try:
                if name == "search":
                    text = self.do_search(args)
                elif name == "list_indexes":
                    text = self.do_list_indexes()
                else:
                    return self._error(msg_id, -32602, f"unknown tool: {name}")
                return self._result(msg_id, {
                    "content": [{"type": "text", "text": text}],
                    "isError": False,
                })
            except Exception as e:
                return self._result(msg_id, {
                    "content": [{"type": "text", "text": f"error: {e}"}],
                    "isError": True,
                })
        if msg_id is None:
            return None  # unknown notification: ignore
        return self._error(msg_id, -32601, f"method not found: {method}")

    @staticmethod
    def _result(msg_id, result):
        return {"jsonrpc": "2.0", "id": msg_id, "result": result}

    @staticmethod
    def _error(msg_id, code, message):
        return {"jsonrpc": "2.0", "id": msg_id,
                "error": {"code": code, "message": message}}

    def run_stdio(self, stdin=None, stdout=None) -> None:
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        print("leann-tpu MCP server on stdio", file=sys.stderr)
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except json.JSONDecodeError as e:
                resp = self._error(None, -32700, f"parse error: {e}")
                stdout.write(json.dumps(resp) + "\n")
                stdout.flush()
                continue
            resp = self.handle(msg)
            if resp is not None:
                stdout.write(json.dumps(resp) + "\n")
                stdout.flush()
