"""Index metadata — JSON schema matching the reference
(`src/index/meta.rs:8-58`) plus engine extensions."""

from __future__ import annotations

import json
from dataclasses import dataclass, asdict
from typing import Any, Dict, Optional

META_VERSION = "1.0"


def meta_path(base: str) -> str:
    return base + ".meta.json"


@dataclass
class IndexMeta:
    version: str = META_VERSION
    backend_name: str = "flat"          # flat | vamana (aliases: hnsw, diskann)
    embedding_model: str = "fake"
    embedding_mode: str = "fake"        # openai | ollama | gemini | local | fake
    dimensions: int = 768
    passage_count: int = 0
    backend_kwargs: Optional[Dict[str, Any]] = None
    embedding_options: Optional[Dict[str, Any]] = None
    is_recompute: bool = False
    is_pruned: bool = False
    # --- engine extensions (absent fields default cleanly when reading
    # reference-written metas) ---
    metric: str = "ip"                  # ip | l2 | cosine

    def save(self, path: str) -> None:
        obj = asdict(self)
        # Match the reference's skip_serializing_if = Option::is_none
        for key in ("backend_kwargs", "embedding_options"):
            if obj[key] is None:
                del obj[key]
        with open(path, "w", encoding="utf-8") as f:
            json.dump(obj, f, indent=2)

    @staticmethod
    def load(path: str) -> "IndexMeta":
        with open(path, "r", encoding="utf-8") as f:
            obj = json.load(f)
        meta = IndexMeta()
        for key, val in obj.items():
            if hasattr(meta, key):
                setattr(meta, key, val)
        return meta
