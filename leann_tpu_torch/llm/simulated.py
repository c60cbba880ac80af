"""Deterministic canned LLM for testing ask/react without any API
(reference `src/llm/simulated.rs:10-57`)."""

from __future__ import annotations


class SimulatedLlm:
    model = "simulated"

    def generate(self, prompt: str) -> str:
        # ReAct loops need an action the parser understands.
        if "Thought:" in prompt and "Action:" in prompt:
            if "Observation:" in prompt:
                return (
                    "Thought: I have enough information from the search "
                    "results to answer.\n"
                    "Action: finish(Based on the retrieved passages, the "
                    "simulated agent concludes its answer here.)"
                )
            return (
                "Thought: I should search the index for relevant passages.\n"
                "Action: search(simulated query)"
            )
        if "Question:" in prompt and "Context:" in prompt:
            return (
                "Based on the provided context, this is a simulated answer "
                "synthesized from the retrieved passages. (SimulatedLlm: no "
                "real model was called.)"
            )
        if "Question:" in prompt:
            return "This is a simulated answer. (SimulatedLlm)"
        return "Simulated response. (SimulatedLlm)"
