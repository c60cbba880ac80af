"""Shared CLI plumbing: file collection (gitignore-aware walk), document
loading, provider construction with CLI > config > meta precedence.

Behavioral parity with the reference's collection rules
(`src/cli/build.rs:414-554`): default extension allowlist, 10KB strict
limit for JSON, build/dependency directory blacklist, gitignore +
.leannignore support, hidden files skipped unless requested.
"""

from __future__ import annotations

import fnmatch
import os
import sys
from typing import TYPE_CHECKING, Iterable, List, Optional, Tuple

from leann_tpu_torch.config import Config
from leann_tpu_torch.embed import EmbeddingProvider, get_model_config

if TYPE_CHECKING:
    from leann_tpu_torch.device import DeviceLike

DEFAULT_EXTENSIONS = [
    ".txt", ".md", ".py", ".js", ".ts", ".tsx", ".jsx", ".rs", ".go", ".java",
    ".c", ".cpp", ".cc", ".h", ".hpp", ".json", ".yaml", ".yml", ".toml",
    ".rb", ".php", ".swift", ".kt", ".scala", ".cs", ".pdf",
]

STRICT_SIZE_EXTENSIONS = {".json"}
STRICT_SIZE_LIMIT = 10 * 1024  # 10KB for data-ish files

DIR_BLACKLIST = {
    "target", "node_modules", ".git", "__pycache__", "venv", ".venv",
    "dist", "build", ".next", ".nuxt", "vendor", "Pods", ".gradle",
    ".cache", "deps", "_build", ".elixir_ls", ".hex", "priv",
}


class _IgnoreRules:
    """Minimal gitignore-style matcher (blank/comment lines, dir suffix /,
    anchored leading /, fnmatch globs). Covers the common cases of the
    reference's `ignore` crate walk."""

    def __init__(self, root: str):
        self.root = root
        self.patterns: List[Tuple[str, bool, bool]] = []  # (pat, is_dir, negate)
        for name in (".gitignore", ".leannignore"):
            path = os.path.join(root, name)
            if os.path.exists(path):
                try:
                    with open(path, "r", encoding="utf-8", errors="replace") as f:
                        for line in f:
                            line = line.rstrip("\n")
                            if not line.strip() or line.startswith("#"):
                                continue
                            negate = line.startswith("!")
                            if negate:
                                line = line[1:]
                            is_dir = line.endswith("/")
                            line = line.rstrip("/")
                            self.patterns.append((line, is_dir, negate))
                except OSError:
                    pass

    def ignored(self, rel_path: str, is_dir: bool) -> bool:
        rel_path = rel_path.replace(os.sep, "/")
        basename = rel_path.rsplit("/", 1)[-1]
        result = False
        for pat, dir_only, negate in self.patterns:
            if dir_only and not is_dir:
                continue
            anchored = pat.startswith("/")
            p = pat.lstrip("/")
            if anchored:
                hit = fnmatch.fnmatch(rel_path, p)
            else:
                hit = fnmatch.fnmatch(basename, p) or fnmatch.fnmatch(
                    rel_path, p
                ) or fnmatch.fnmatch(rel_path, f"*/{p}")
            if hit:
                result = not negate
        return result


def collect_file_paths(
    paths: Iterable[str],
    file_types: Optional[List[str]] = None,
    exclude_types: Optional[List[str]] = None,
    include_hidden: bool = False,
    max_files: Optional[int] = None,
    max_file_size_kb: int = 1024,
) -> List[str]:
    max_bytes = max_file_size_kb * 1024
    allowed = [e if e.startswith(".") else "." + e for e in (file_types or DEFAULT_EXTENSIONS)]
    excluded = [e if e.startswith(".") else "." + e for e in (exclude_types or [])]
    out: List[str] = []

    def admit(path: str) -> bool:
        ext = os.path.splitext(path)[1]
        if not ext or ext in excluded or ext not in allowed:
            return False
        try:
            size = os.path.getsize(path)
        except OSError:
            return False
        limit = STRICT_SIZE_LIMIT if ext in STRICT_SIZE_EXTENSIONS else max_bytes
        return size <= limit

    for root_path in paths:
        if max_files is not None and len(out) >= max_files:
            break
        if os.path.isfile(root_path):
            if admit(root_path):
                out.append(root_path)
            continue
        if not os.path.isdir(root_path):
            continue
        rules = _IgnoreRules(root_path)
        for dirpath, dirnames, filenames in os.walk(root_path):
            rel_dir = os.path.relpath(dirpath, root_path)
            # prune directories in place
            keep = []
            for d in sorted(dirnames):
                if d in DIR_BLACKLIST:
                    continue
                if not include_hidden and d.startswith("."):
                    continue
                rel = d if rel_dir == "." else f"{rel_dir}/{d}"
                if rules.ignored(rel, is_dir=True):
                    continue
                keep.append(d)
            dirnames[:] = keep
            for fname in sorted(filenames):
                if max_files is not None and len(out) >= max_files:
                    return out
                if not include_hidden and fname.startswith("."):
                    continue
                rel = fname if rel_dir == "." else f"{rel_dir}/{fname}"
                if rules.ignored(rel, is_dir=False):
                    continue
                full = os.path.join(dirpath, fname)
                if admit(full):
                    out.append(full)
    return out


def load_file_content(path: str) -> Optional[str]:
    """Text loader. PDFs extract out of the box (reference parity:
    build.rs:631-661 bundles pdf-extract): pypdf when installed, else
    the built-in pure-Python extractor (utils/pdftext.py)."""
    if path.lower().endswith(".pdf"):
        try:
            import pypdf

            reader = pypdf.PdfReader(path)
            return "\n".join(page.extract_text() or "" for page in reader.pages)
        except ImportError:
            from leann_tpu_torch.utils.pdftext import extract_pdf_text

            text = extract_pdf_text(path)
            if not text:
                print(f"  skipping {path}: no extractable text",
                      file=sys.stderr)
                return None
            return text
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            return f.read()
    except OSError as e:
        print(f"  skipping {path}: {e}", file=sys.stderr)
        return None


def make_provider(
    mode: str,
    model: str,
    config: Optional[Config] = None,
    host: Optional[str] = None,
    base_url: Optional[str] = None,
    api_key: Optional[str] = None,
    model_path: Optional[str] = None,
    batch_size: Optional[int] = None,
    dimensions: Optional[int] = None,
    device: DeviceLike = None,
) -> EmbeddingProvider:
    """CLI > config-file > defaults precedence (reference build.rs:160-191).
    `device` places the local encoder (None = cuda)."""
    cfg = config or Config.load()
    # CLI default "openai" yields to the config file's provider choice
    if mode == "openai" and cfg.embedding.provider != "openai":
        mode = cfg.embedding.provider
    if model == "text-embedding-3-small" and cfg.embedding.model:
        model = cfg.embedding.model
    return EmbeddingProvider(
        mode=mode,
        model=model,
        host=host or cfg.embedding.host,
        base_url=base_url or cfg.embedding.base_url,
        api_key=api_key or cfg.embedding.api_key,
        model_path=model_path,
        batch_size=batch_size or cfg.embedding.batch_size,
        dimensions=dimensions,
        device=device,
    )


def provider_from_meta(meta, api_key=None, host=None, base_url=None,
                       device: DeviceLike = None) -> EmbeddingProvider:
    """Rebuild the provider an index was created with (reference
    search.rs:100-117). `device` places the local encoder (None = cuda)."""
    opts = meta.embedding_options or {}
    return EmbeddingProvider(
        mode=meta.embedding_mode,
        model=meta.embedding_model,
        host=host or opts.get("host"),
        base_url=base_url or opts.get("base_url"),
        api_key=api_key,
        model_path=opts.get("model_path"),
        dimensions=meta.dimensions if meta.embedding_mode == "fake" else None,
        device=device,
    )


def resolve_query_template(
    cli_template: Optional[str], meta
) -> Optional[str]:
    """CLI -> meta.embedding_options -> model registry
    (reference search.rs:120-129)."""
    if cli_template is not None:
        return cli_template
    opts = meta.embedding_options or {}
    if "query_prompt_template" in opts:
        return opts["query_prompt_template"]
    return get_model_config(meta.embedding_model).query_prefix or None


def resolve_build_template(meta, provider) -> Optional[str]:
    """Document-side template for re-embedding (update / recompute):
    the template the index was BUILT with (meta.embedding_options,
    reference build.rs:344-352) wins over the provider's model default,
    so custom-template indexes stay in one embedding space."""
    opts = meta.embedding_options or {}
    if "build_prompt_template" in opts:
        return opts["build_prompt_template"] or None
    return provider.document_prefix() or None
