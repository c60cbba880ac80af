"""`ask` — RAG Q&A, one-shot or interactive REPL (port of
`leann_tpu/cli/ask_cmd.py`; reference `src/cli/ask.rs:64-317`: /help
/clear /history /quit commands, history persisted to
~/.leann/history.txt), searching on `args.device`."""

from __future__ import annotations

import os
import sys

from leann_tpu_torch.cli.common import provider_from_meta, resolve_query_template
from leann_tpu_torch.cli.main import primary_device
from leann_tpu_torch.index.searcher import IndexSearcher
from leann_tpu_torch.llm import LlmProvider
from leann_tpu_torch.rag.ask import AskSession
from leann_tpu_torch.store.locate import find_index, index_base
from leann_tpu_torch.store.meta import IndexMeta, meta_path

HISTORY_PATH = os.path.join(os.path.expanduser("~"), ".leann", "history.txt")


def add_parser(sub):
    p = sub.add_parser("ask", help="Ask questions using RAG")
    p.add_argument("question", nargs="?", default=None,
                   help="Question (omit for interactive mode)")
    p.add_argument("-i", "--index", default=None)
    p.add_argument("--top-k", type=int, default=5)
    p.add_argument("--complexity", type=int, default=64)
    p.add_argument("--llm", default="ollama",
                   choices=["ollama", "openai", "anthropic", "simulated"])
    p.add_argument("--model", default=None, help="LLM model name")
    p.add_argument("--llm-host", default=None)
    p.add_argument("--api-key", default=None)
    p.add_argument("--show-sources", action="store_true")
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--embedding-api-key", default=os.environ.get("OPENAI_API_KEY"))
    p.add_argument("--query-prompt-template", default=None)
    p.set_defaults(func=run)


def _make_session(args) -> AskSession:
    index_name = args.index or os.path.basename(os.getcwd())
    index_dir = find_index(index_name)
    base = index_base(index_dir)
    meta = IndexMeta.load(meta_path(base))
    device = primary_device(args.device)
    provider = provider_from_meta(meta, api_key=args.embedding_api_key,
                                  device=device)
    template = resolve_query_template(args.query_prompt_template, meta)
    llm = LlmProvider(
        mode=args.llm, model=args.model, host=args.llm_host, api_key=args.api_key
    )
    searcher = IndexSearcher.load(base, device=device)
    return AskSession(
        searcher, provider, llm,
        query_template=template, top_k=args.top_k, complexity=args.complexity,
    )


def _answer(session: AskSession, question: str, show_sources: bool) -> None:
    result = session.ask(question)
    print(result.answer)
    if show_sources:
        print("\nSources:")
        for i, s in enumerate(result.sources):
            print(f"  [{i + 1}] {s.id} (score {s.score:.3f})")


def run(args) -> int:
    try:
        session = _make_session(args)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 1

    if args.question and not args.interactive:
        _answer(session, args.question, args.show_sources)
        return 0

    # interactive REPL with line editing: readline gives arrow keys,
    # Ctrl-R search, and in-session history recall over the same
    # persisted history file (reference uses rustyline, ask.rs:200-317)
    history = []
    os.makedirs(os.path.dirname(HISTORY_PATH), exist_ok=True)
    if os.path.exists(HISTORY_PATH):
        with open(HISTORY_PATH, "r", encoding="utf-8") as f:
            history = [line.rstrip("\n") for line in f]
    try:
        import readline  # noqa: F401 — side effect: input() line editing

        for h in history[-1000:]:
            readline.add_history(h)
    except ImportError:  # non-readline platform: plain input() still works
        pass
    print("Interactive RAG. Commands: /help /clear /history /quit")
    while True:
        try:
            line = input("ask> ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if not line:
            continue
        if line in ("/quit", "/exit", "/q"):
            break
        if line == "/help":
            print("/help   show this help\n/clear  clear screen\n"
                  "/history  show question history\n/quit   exit")
            continue
        if line == "/clear":
            print("\033[2J\033[H", end="")
            continue
        if line == "/history":
            for h in history[-20:]:
                print(f"  {h}")
            continue
        history.append(line)
        with open(HISTORY_PATH, "a", encoding="utf-8") as f:
            f.write(line + "\n")
        try:
            _answer(session, line, args.show_sources)
        except Exception as e:  # keep the REPL alive on provider errors
            print(f"error: {e}", file=sys.stderr)
    return 0
