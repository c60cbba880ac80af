"""Ollama LLM provider: POST {host}/api/generate
(reference `src/llm/ollama.rs:68-79` — parses line-delimited JSON)."""

from __future__ import annotations

import json
from typing import Optional

from leann_tpu_torch.embed.ollama import resolve_host


class OllamaLlm:
    def __init__(self, model: str = "llama3.2", host: Optional[str] = None):
        self.model = model
        self.host = resolve_host(host)

    def generate(self, prompt: str) -> str:
        import urllib.request

        payload = json.dumps(
            {"model": self.model, "prompt": prompt, "stream": False}
        ).encode("utf-8")
        req = urllib.request.Request(
            f"{self.host}/api/generate",
            data=payload,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=300) as resp:
            # Robust to both single-JSON and line-delimited stream bodies.
            body = resp.read().decode("utf-8")
        parts = []
        for line in body.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            parts.append(obj.get("response", ""))
        return "".join(parts)
