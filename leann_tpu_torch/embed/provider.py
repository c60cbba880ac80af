"""EmbeddingProvider facade with enum-style dispatch, matching the
reference's surface (`src/embedding/mod.rs:35-164`): `embed()` plus
`embed_with_template()` which prepends the document/query prefix for
asymmetric models.

Modes: openai (also "lmstudio" via base_url), ollama, gemini, local
(the port's BERT on `device`, default cuda), fake (deterministic test
embedder). Only the local mode touches torch or a device.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np

from leann_tpu_torch.embed.registry import get_model_config

if TYPE_CHECKING:
    from leann_tpu_torch.device import DeviceLike

# E5/BGE/Instructor-style template constants (reference embedding/mod.rs:151-164)
E5_QUERY_TEMPLATE = "query: "
E5_PASSAGE_TEMPLATE = "passage: "
BGE_QUERY_TEMPLATE = "Represent this sentence for searching relevant passages: "


class EmbeddingProvider:
    def __init__(
        self,
        mode: str = "fake",
        model: str = "fake",
        host: Optional[str] = None,
        base_url: Optional[str] = None,
        api_key: Optional[str] = None,
        model_path: Optional[str] = None,
        dimensions: Optional[int] = None,
        batch_size: Optional[int] = None,
        device: DeviceLike = None,
    ):
        mode = (mode or "fake").lower()
        if mode == "lmstudio":
            # LM Studio is the OpenAI-compatible path with a local base_url
            # (reference build.rs:176-179).
            mode = "openai"
            base_url = base_url or "http://localhost:1234/v1"
        self.mode = mode
        self.model = model

        if mode == "fake":
            from leann_tpu_torch.embed.fake import FakeEmbedding

            # the fake embedder is symmetric: never apply registry prefixes
            self.model = "fake"
            self._impl = FakeEmbedding(dimensions or 64)
        elif mode == "openai":
            from leann_tpu_torch.embed.openai import OpenAIEmbedding

            self._impl = OpenAIEmbedding(
                model, api_key=api_key, base_url=base_url,
                batch_size=batch_size or 100,
            )
        elif mode == "ollama":
            from leann_tpu_torch.embed.ollama import OllamaEmbedding

            self._impl = OllamaEmbedding(model, host=host, batch_size=batch_size or 32)
        elif mode == "gemini":
            from leann_tpu_torch.embed.gemini import GeminiEmbedding

            self._impl = GeminiEmbedding(model, api_key=api_key)
        elif mode == "local":
            from leann_tpu_torch.embed.local import LocalEmbedding

            # model_path wins; otherwise any other model name is taken as
            # a checkpoint directory (the encoder raises when it is not
            # one: the port loads nothing from a hub). The placeholder
            # names keep the hermetic tiny encoder for tests/bring-up.
            path = model_path or (
                model if model not in ("fake", "local-tiny") else None
            )
            self._impl = LocalEmbedding(path, batch_size=batch_size or 128,
                                        device=device)
        else:
            raise ValueError(
                f"unknown embedding mode {mode!r} "
                "(openai|lmstudio|ollama|gemini|local|fake)"
            )

    @property
    def dimensions(self) -> int:
        return self._impl.dimensions

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dimensions), dtype=np.float32)
        return np.asarray(self._impl.embed(list(texts)), dtype=np.float32)

    def embed_with_template(
        self, texts: Sequence[str], template: Optional[str]
    ) -> np.ndarray:
        if template:
            texts = [template + t for t in texts]
        return self.embed(texts)

    def document_prefix(self) -> str:
        return get_model_config(self.model).document_prefix

    def query_prefix(self) -> str:
        return get_model_config(self.model).query_prefix
