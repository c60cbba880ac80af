"""Serving surfaces: HTTP API + MCP stdio server (port of
`leann_tpu/server/`)."""
