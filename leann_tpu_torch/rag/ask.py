"""RAG: retrieve top-k passages, stuff a prompt, generate.

Same pipeline as the reference (`src/cli/ask.rs:157-198`): numbered
context passages followed by the question; the interactive REPL lives in
cli/ask.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from leann_tpu_torch.index.searcher import IndexSearcher, SearchOptions, SearchResult
from leann_tpu_torch.llm import LlmProvider


def build_prompt(question: str, passages: Sequence[SearchResult]) -> str:
    ctx = "\n\n".join(
        f"[{i + 1}] {p.text}" for i, p in enumerate(passages)
    )
    return (
        "Answer the question based on the provided context.\n\n"
        f"Context:\n{ctx}\n\n"
        f"Question: {question}\n\n"
        "Answer:"
    )


@dataclass
class AskAnswer:
    answer: str
    sources: List[SearchResult]


class AskSession:
    def __init__(
        self,
        searcher: IndexSearcher,
        embed_provider,
        llm: LlmProvider,
        query_template: Optional[str] = None,
        top_k: int = 5,
        complexity: int = 64,
    ):
        self.searcher = searcher
        self.embed_provider = embed_provider
        self.llm = llm
        self.query_template = query_template
        self.top_k = top_k
        self.complexity = complexity

    def retrieve(self, question: str) -> List[SearchResult]:
        q = self.embed_provider.embed_with_template(
            [question], self.query_template
        )
        return self.searcher.search(
            q, SearchOptions(top_k=self.top_k, complexity=self.complexity)
        )[0]

    def ask(self, question: str) -> AskAnswer:
        passages = self.retrieve(question)
        prompt = build_prompt(question, passages)
        answer = self.llm.generate(prompt)
        return AskAnswer(answer=answer, sources=passages)
