"""LLM providers for RAG and the ReAct agent.

Mirrors the reference surface (`src/llm/mod.rs:12-69`): modes ollama /
openai / anthropic / simulated behind one `LlmProvider.generate(prompt)`
facade. `simulated` returns canned deterministic text so ask/react run
with zero network (reference `src/llm/simulated.rs`).
"""

from __future__ import annotations

from typing import Optional


class LlmProvider:
    def __init__(
        self,
        mode: str = "simulated",
        model: Optional[str] = None,
        host: Optional[str] = None,
        api_key: Optional[str] = None,
        base_url: Optional[str] = None,
        max_tokens: int = 1000,
    ):
        mode = (mode or "simulated").lower()
        self.mode = mode
        if mode == "simulated":
            from leann_tpu_torch.llm.simulated import SimulatedLlm

            self._impl = SimulatedLlm()
        elif mode == "ollama":
            from leann_tpu_torch.llm.ollama import OllamaLlm

            self._impl = OllamaLlm(model or "llama3.2", host=host)
        elif mode == "openai":
            from leann_tpu_torch.llm.openai import OpenAILlm

            self._impl = OpenAILlm(
                model or "gpt-4o-mini", api_key=api_key, base_url=base_url,
                max_tokens=max_tokens,
            )
        elif mode == "anthropic":
            from leann_tpu_torch.llm.anthropic import AnthropicLlm

            self._impl = AnthropicLlm(
                model or "claude-sonnet-4-5", api_key=api_key,
                max_tokens=max_tokens,
            )
        else:
            raise ValueError(
                f"unknown llm mode {mode!r} (ollama|openai|anthropic|simulated)"
            )
        self.model = getattr(self._impl, "model", mode)

    def generate(self, prompt: str) -> str:
        return self._impl.generate(prompt)
