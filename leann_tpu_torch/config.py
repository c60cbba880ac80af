"""User configuration: TOML at ~/.config/leann/config.toml.

Same file location, sections, keys and precedence (CLI flag > config file >
hard default) as the reference (`src/config.rs:24-226`). Read with stdlib
tomllib; written as TOML text (stdlib has no writer).
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field
from typing import List, Optional

DEFAULT_PROVIDER = "ollama"
DEFAULT_MODEL = "nomic-embed-text"
DEFAULT_CHUNK_SIZE = 256
DEFAULT_CHUNK_OVERLAP = 128
DEFAULT_MAX_FILE_SIZE_KB = 1024


@dataclass
class EmbeddingConfig:
    provider: str = DEFAULT_PROVIDER
    model: str = DEFAULT_MODEL
    host: Optional[str] = None
    base_url: Optional[str] = None
    api_key: Optional[str] = None
    prompt_template: Optional[str] = None
    batch_size: Optional[int] = None


@dataclass
class BuildConfig:
    chunk_size: int = DEFAULT_CHUNK_SIZE
    chunk_overlap: int = DEFAULT_CHUNK_OVERLAP
    max_file_size_kb: int = DEFAULT_MAX_FILE_SIZE_KB
    file_types: Optional[List[str]] = None
    exclude_types: Optional[List[str]] = None


@dataclass
class Config:
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    build: BuildConfig = field(default_factory=BuildConfig)

    @staticmethod
    def config_path() -> str:
        xdg = os.environ.get("XDG_CONFIG_HOME") or os.path.join(
            os.path.expanduser("~"), ".config"
        )
        return os.path.join(xdg, "leann", "config.toml")

    @staticmethod
    def load(path: Optional[str] = None) -> "Config":
        path = path or Config.config_path()
        cfg = Config()
        if not os.path.exists(path):
            return cfg
        with open(path, "rb") as f:
            data = tomllib.load(f)
        emb = data.get("embedding", {})
        for key in vars(cfg.embedding):
            if key in emb:
                setattr(cfg.embedding, key, emb[key])
        bld = data.get("build", {})
        for key in vars(cfg.build):
            if key in bld:
                setattr(cfg.build, key, bld[key])
        return cfg

    def to_toml(self) -> str:
        def kv(k, v):
            if v is None:
                return None
            if isinstance(v, bool):
                return f"{k} = {'true' if v else 'false'}"
            if isinstance(v, (int, float)):
                return f"{k} = {v}"
            if isinstance(v, list):
                items = ", ".join(f'"{x}"' for x in v)
                return f"{k} = [{items}]"
            return f'{k} = "{v}"'

        lines = ["[embedding]"]
        for k, v in vars(self.embedding).items():
            line = kv(k, v)
            if line:
                lines.append(line)
        lines.append("")
        lines.append("[build]")
        for k, v in vars(self.build).items():
            line = kv(k, v)
            if line:
                lines.append(line)
        lines.append("")
        return "\n".join(lines)

    def save(self, path: Optional[str] = None) -> str:
        path = path or Config.config_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_toml())
        return path


EXAMPLE_CONFIG = """\
# LEANN-TPU configuration
# Location: ~/.config/leann/config.toml

[embedding]
provider = "ollama"          # ollama, lmstudio, openai, gemini, local, fake
model = "nomic-embed-text"
# host = "http://localhost:11434"        # for ollama
# base_url = "http://localhost:1234/v1"  # for lmstudio / openai-compatible
# api_key = "sk-..."                     # for openai / gemini
# batch_size = 100

[build]
chunk_size = 256
chunk_overlap = 128
max_file_size_kb = 1024
# file_types = ["rs", "py", "md"]
# exclude_types = ["json"]
"""
