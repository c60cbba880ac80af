"""Embedding providers (port of `leann_tpu/embed/`).

The provider surface of the reference (`src/embedding/mod.rs:17-164`):
modes openai / ollama / gemini / local plus `fake` (deterministic hash
embedder for hermetic tests). `local` runs the port's BERT on the
device it is given (default cuda); the other modes are host code.
`LocalEmbedding` is imported lazily, so importing this package pulls in
no torch.
"""

from leann_tpu_torch.embed.fake import FakeEmbedding
from leann_tpu_torch.embed.provider import EmbeddingProvider
from leann_tpu_torch.embed.registry import ModelConfig, get_model_config

__all__ = ["EmbeddingProvider", "ModelConfig", "get_model_config",
           "FakeEmbedding", "LocalEmbedding"]


def __getattr__(name):
    if name == "LocalEmbedding":
        from leann_tpu_torch.embed.local import LocalEmbedding

        return LocalEmbedding
    raise AttributeError(
        f"module 'leann_tpu_torch.embed' has no attribute {name!r}")
