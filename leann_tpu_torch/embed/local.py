"""Local embedding provider: BERT on the same device as the search
engine (port of `leann_tpu/embed/local.py`), batch of 128 by default.
`model_path` may point at a HuggingFace checkpoint directory (config.json
+ model.safetensors + tokenizer files); otherwise a tiny random-weight
encoder with a hash tokenizer is used (deterministic, hermetic: for
tests and pipeline bring-up). `encoder` hands over a `BertEncoder` built
elsewhere (another width, another device).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from leann_tpu_torch.device import DeviceLike


class LocalEmbedding:
    def __init__(self, model_path: Optional[str] = None, batch_size: int = 128,
                 device: DeviceLike = None, encoder=None):
        from leann_tpu_torch.models.bert import BertConfig, BertEncoder

        self.model_path = model_path
        self.batch_size = batch_size
        self.encoder = encoder or BertEncoder(
            config=None if model_path else BertConfig.tiny(),
            model_dir=model_path,
            device=device,
        )
        self.dimensions = self.encoder.dimensions
        self.model = model_path or "local-tiny"

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        return self.encoder.embed(list(texts), batch_size=self.batch_size)
