"""Embedding providers: the hermetic fake embedder and the local BERT
encoder. The HTTP providers come with the serving surface."""

from leann_tpu_torch.embed.fake import FakeEmbedding
from leann_tpu_torch.embed.local import LocalEmbedding

__all__ = ["FakeEmbedding", "LocalEmbedding"]
