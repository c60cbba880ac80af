"""ReAct agent: Thought -> Action loop with search()/finish() tools.

Same agent shape as the reference (`src/cli/react.rs:88-245`): a system
prompt advertising two tools, a bounded step loop, a tolerant action
parser, search observations truncated to snippets, and a fallback finish
prompt when steps run out.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

from leann_tpu_torch.index.searcher import IndexSearcher, SearchOptions
from leann_tpu_torch.llm import LlmProvider

SNIPPET_CHARS = 300

SYSTEM_PROMPT = """\
You are a research agent that answers questions by searching a document
index. You reason step by step.

Available actions:
  search(query)  - search the index; returns top passages
  finish(answer) - provide the final answer and stop

Format every step exactly as:
Thought: <your reasoning>
Action: search(<query>) or finish(<answer>)

Question: {question}
"""


@dataclass
class Action:
    kind: str  # "search" | "finish"
    arg: str


def parse_action(text: str) -> Optional[Action]:
    """Tolerant parser: finds the last `Action:` line and pulls the call
    out of it, accepting unbalanced/absent closing parens."""
    matches = list(
        re.finditer(
            r"Action:\s*(search|finish)\s*\((.*?)\)\s*$",
            text,
            re.IGNORECASE | re.DOTALL | re.MULTILINE,
        )
    )
    if not matches:
        # missing close paren: grab to end of text
        m = re.search(
            r"Action:\s*(search|finish)\s*\((.*)",
            text,
            re.IGNORECASE | re.DOTALL,
        )
        if not m:
            return None
        return Action(m.group(1).lower(), m.group(2).strip().rstrip(")").strip())
    m = matches[-1]
    return Action(m.group(1).lower(), m.group(2).strip())


@dataclass
class ReActStep:
    thought_action: str
    observation: Optional[str] = None


class ReActAgent:
    def __init__(
        self,
        searcher: IndexSearcher,
        embed_provider,
        llm: LlmProvider,
        query_template: Optional[str] = None,
        top_k: int = 3,
        complexity: int = 64,
        max_steps: int = 5,
    ):
        self.searcher = searcher
        self.embed_provider = embed_provider
        self.llm = llm
        self.query_template = query_template
        self.top_k = top_k
        self.complexity = complexity
        self.max_steps = max_steps

    def execute_search(self, query: str) -> str:
        q = self.embed_provider.embed_with_template([query], self.query_template)
        results = self.searcher.search(
            q, SearchOptions(top_k=self.top_k, complexity=self.complexity)
        )[0]
        if not results:
            return "No results found."
        lines = []
        for i, r in enumerate(results):
            snippet = r.text[:SNIPPET_CHARS]
            if len(r.text) > SNIPPET_CHARS:
                snippet += "..."
            lines.append(f"[{i + 1}] ({r.id}) {snippet}")
        return "\n".join(lines)

    def run(self, question: str) -> Tuple[str, List[ReActStep]]:
        history = SYSTEM_PROMPT.format(question=question)
        steps: List[ReActStep] = []
        for _ in range(self.max_steps):
            response = self.llm.generate(history)
            history += "\n" + response
            action = parse_action(response)
            if action is None:
                history += (
                    "\nObservation: Could not parse an action. Use "
                    "`Action: search(<query>)` or `Action: finish(<answer>)`."
                )
                steps.append(ReActStep(response, "parse error"))
                continue
            if action.kind == "finish":
                steps.append(ReActStep(response))
                return action.arg, steps
            observation = self.execute_search(action.arg)
            history += f"\nObservation: {observation}"
            steps.append(ReActStep(response, observation))
        # out of steps: force a final answer (reference react.rs:163-170)
        final = self.llm.generate(
            history
            + "\nYou have run out of steps. Provide your best final answer "
            "now, as plain text."
        )
        steps.append(ReActStep(final))
        return final, steps
