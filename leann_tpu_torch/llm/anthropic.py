"""Anthropic Messages API provider (reference `src/llm/anthropic.rs:73-106`:
raw /v1/messages, anthropic-version 2023-06-01, text blocks concatenated)."""

from __future__ import annotations

import os
from typing import Optional

from leann_tpu_torch.embed.httpx import post_json

API_BASE = "https://api.anthropic.com/v1"
API_VERSION = "2023-06-01"


class AnthropicLlm:
    def __init__(
        self,
        model: str = "claude-sonnet-4-5",
        api_key: Optional[str] = None,
        max_tokens: int = 1000,
    ):
        self.model = model
        self.api_key = api_key or os.environ.get("ANTHROPIC_API_KEY", "")
        self.max_tokens = max_tokens

    def generate(self, prompt: str) -> str:
        resp = post_json(
            f"{API_BASE}/messages",
            {
                "model": self.model,
                "max_tokens": self.max_tokens,
                "messages": [{"role": "user", "content": prompt}],
            },
            headers={
                "x-api-key": self.api_key,
                "anthropic-version": API_VERSION,
            },
        )
        return "".join(
            block.get("text", "")
            for block in resp.get("content", [])
            if block.get("type") == "text"
        )
