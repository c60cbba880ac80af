"""`react` — ReAct agent loop (port of `leann_tpu/cli/react_cmd.py`;
reference `src/cli/react.rs:247-322`), searching on `args.device`."""

from __future__ import annotations

import os
import sys

from leann_tpu_torch.agent.react import ReActAgent
from leann_tpu_torch.cli.common import provider_from_meta, resolve_query_template
from leann_tpu_torch.cli.main import primary_device
from leann_tpu_torch.index.searcher import IndexSearcher
from leann_tpu_torch.llm import LlmProvider
from leann_tpu_torch.store.locate import find_index, index_base
from leann_tpu_torch.store.meta import IndexMeta, meta_path


def add_parser(sub):
    p = sub.add_parser("react", help="ReAct agent for multi-turn reasoning")
    p.add_argument("question")
    p.add_argument("-i", "--index", default=None)
    p.add_argument("--top-k", type=int, default=3)
    p.add_argument("--complexity", type=int, default=64)
    p.add_argument("--max-steps", type=int, default=5)
    p.add_argument("--llm", default="ollama",
                   choices=["ollama", "openai", "anthropic", "simulated"])
    p.add_argument("--model", default=None)
    p.add_argument("--llm-host", default=None)
    p.add_argument("--api-key", default=None)
    p.add_argument("--show-steps", action="store_true")
    p.add_argument("--embedding-api-key", default=os.environ.get("OPENAI_API_KEY"))
    p.set_defaults(func=run)


def run(args) -> int:
    index_name = args.index or os.path.basename(os.getcwd())
    try:
        index_dir = find_index(index_name)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 1
    base = index_base(index_dir)
    meta = IndexMeta.load(meta_path(base))
    device = primary_device(args.device)
    provider = provider_from_meta(meta, api_key=args.embedding_api_key,
                                  device=device)
    template = resolve_query_template(None, meta)
    llm = LlmProvider(
        mode=args.llm, model=args.model, host=args.llm_host, api_key=args.api_key
    )
    agent = ReActAgent(
        IndexSearcher.load(base, device=device), provider, llm,
        query_template=template, top_k=args.top_k,
        complexity=args.complexity, max_steps=args.max_steps,
    )
    answer, steps = agent.run(args.question)
    if args.show_steps:
        for i, step in enumerate(steps):
            print(f"--- step {i + 1} ---")
            print(step.thought_action)
            if step.observation:
                print(f"Observation: {step.observation}")
        print("--- answer ---")
    print(answer)
    return 0
