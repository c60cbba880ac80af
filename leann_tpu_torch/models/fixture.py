"""Shape-exact HuggingFace-format BERT checkpoint fixture (the port's
copy of `leann_tpu/models/fixture.py`: the same files from the same seed).

Where no pretrained weights are at hand, the real-checkpoint path
(safetensors load -> tokenize -> forward -> mean-pool) is exercised
against a *generated* checkpoint that has the artifact shape of a hub
snapshot:

  config.json             HF BertConfig JSON (model_type "bert")
  model.safetensors       HF BertModel parameter names/shapes (incl.
                          pooler, which leann ignores like candle does)
  vocab.txt               real WordPiece vocab (specials + words +
                          ##subwords) so BertTokenizer(Fast) loads it
  tokenizer_config.json   tokenizer_class BertTokenizer

Weights are random but seeded; the identical directory loads into the
reference's JAX encoder and into `leann_tpu_torch.models.bert`, and the
two produce matching pooled embeddings (tests/test_torch_bert.py).
"""

from __future__ import annotations

import json
import os

import numpy as np

# A small but real WordPiece vocabulary: continuation pieces force the
# tokenizer's subword path, punctuation splits exercise BasicTokenizer.
_WORDS = [
    "the", "a", "of", "and", "to", "document", "passage", "index",
    "search", "vector", "query", "graph", "build", "test", "hello",
    "world", "quick", "brown", "fox", "jump", "lazy", "dog", "data",
    "base", "token", "embed", "model", "layer", "prune", "text",
]
_SUBWORDS = ["##s", "##ing", "##ed", "##er", "##ly", "##ion", "##ment"]
_CHARS = [c for c in "abcdefghijklmnopqrstuvwxyz0123456789.,!?-"]


def write_bert_fixture(
    out_dir: str,
    hidden_size: int = 64,
    num_layers: int = 2,
    num_heads: int = 2,
    intermediate_size: int = 128,
    max_position_embeddings: int = 128,
    hidden_act: str = "gelu",
    seed: int = 0,
) -> str:
    """Write the fixture checkpoint into `out_dir`; returns `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += _CHARS + _WORDS + _SUBWORDS
    vocab_size = len(vocab)
    with open(os.path.join(out_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    with open(
        os.path.join(out_dir, "tokenizer_config.json"), "w", encoding="utf-8"
    ) as f:
        json.dump(
            {"tokenizer_class": "BertTokenizer", "do_lower_case": True,
             "model_max_length": max_position_embeddings},
            f,
        )
    cfg = {
        "architectures": ["BertModel"],
        "model_type": "bert",
        "vocab_size": vocab_size,
        "hidden_size": hidden_size,
        "num_hidden_layers": num_layers,
        "num_attention_heads": num_heads,
        "intermediate_size": intermediate_size,
        "max_position_embeddings": max_position_embeddings,
        "type_vocab_size": 2,
        "layer_norm_eps": 1e-12,
        "hidden_act": hidden_act,
        "hidden_dropout_prob": 0.0,
        "attention_probs_dropout_prob": 0.0,
        "pad_token_id": 0,
    }
    with open(os.path.join(out_dir, "config.json"), "w", encoding="utf-8") as f:
        json.dump(cfg, f, indent=2)

    rng = np.random.default_rng(seed)
    h, inter = hidden_size, intermediate_size

    def w(*shape, scale=0.05):
        return rng.normal(0.0, scale, shape).astype(np.float32)

    tensors = {
        "embeddings.word_embeddings.weight": w(vocab_size, h, scale=0.02),
        "embeddings.position_embeddings.weight": w(
            max_position_embeddings, h, scale=0.02),
        "embeddings.token_type_embeddings.weight": w(2, h, scale=0.02),
        "embeddings.LayerNorm.weight": np.ones(h, np.float32),
        "embeddings.LayerNorm.bias": np.zeros(h, np.float32),
        # torch BertModel instantiates the pooler even when unused;
        # the loader ignores it.
        "pooler.dense.weight": w(h, h),
        "pooler.dense.bias": np.zeros(h, np.float32),
    }
    for i in range(num_layers):
        stem = f"encoder.layer.{i}"
        for name, (no, ni) in {
            "attention.self.query": (h, h),
            "attention.self.key": (h, h),
            "attention.self.value": (h, h),
            "attention.output.dense": (h, h),
            "intermediate.dense": (inter, h),
            "output.dense": (h, inter),
        }.items():
            tensors[f"{stem}.{name}.weight"] = w(no, ni)
            tensors[f"{stem}.{name}.bias"] = np.zeros(no, np.float32)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            tensors[f"{stem}.{ln}.weight"] = np.ones(h, np.float32)
            tensors[f"{stem}.{ln}.bias"] = np.zeros(h, np.float32)

    from safetensors.numpy import save_file

    save_file(tensors, os.path.join(out_dir, "model.safetensors"))
    return out_dir
