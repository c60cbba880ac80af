"""OpenAI-compatible chat LLM provider
(reference `src/llm/openai.rs:46-53`: single user message, max_tokens 1000)."""

from __future__ import annotations

import os
from typing import Optional

from leann_tpu_torch.embed.httpx import post_json


class OpenAILlm:
    def __init__(
        self,
        model: str = "gpt-4o-mini",
        api_key: Optional[str] = None,
        base_url: Optional[str] = None,
        max_tokens: int = 1000,
    ):
        self.model = model
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self.base_url = (
            base_url
            or os.environ.get("OPENAI_BASE_URL")
            or "https://api.openai.com/v1"
        ).rstrip("/")
        self.max_tokens = max_tokens

    def generate(self, prompt: str) -> str:
        resp = post_json(
            f"{self.base_url}/chat/completions",
            {
                "model": self.model,
                "messages": [{"role": "user", "content": prompt}],
                "max_tokens": self.max_tokens,
            },
            headers={"Authorization": f"Bearer {self.api_key}"},
        )
        return resp["choices"][0]["message"]["content"]
