"""Embedding providers. This slice carries only the hermetic fake
embedder; the HTTP and local-encoder providers come with later slices."""

from leann_tpu_torch.embed.fake import FakeEmbedding

__all__ = ["FakeEmbedding"]
