"""BERT-style text encoder in PyTorch (port of `leann_tpu/models/bert.py`).

tokenize -> pad -> forward -> attention-masked mean-pool -> optional L2
normalize. The weights travel as the reference's pytree of numpy arrays
(`init_params`, `load_hf_params`: "embeddings", "layers"[i]["q"|"k"|...],
dense kernels stored [in, out]); `params_from_reference` carries such a
pytree into a `BertParams` module on the device, which `bert_forward`
reads.

Arithmetic, as the reference's:
  - `compute_dtype="bfloat16"` (the default) rounds both operands of
    every dense product and of the context product to bf16 and keeps the
    float32 accumulator. `torch.matmul` on bf16 tensors would round its
    result to bf16; `_mm` asks `torch.bmm` for a float32 result
    (`out_dtype`) on the card where this PyTorch has that argument and
    otherwise multiplies the bf16-rounded operands widened to float32
    (always so on the CPU). The score product q k^T takes the float32
    outputs un-rounded.
  - layer norm uses the biased variance with eps inside the rsqrt, in
    float32; the additive attention mask is -1e9; pooling divides by
    max(mask sum, 1) and the norm adds 1e-12.
The forward is matmul, softmax, layer norm and GELU, none of which is a
Pallas kernel in the reference, so plain PyTorch ops serve it.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from leann_tpu_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    normalize_output: bool = True
    # "gelu" = exact erf GELU (the HF BERT default); "gelu_new" /
    # "gelu_pytorch_tanh" = tanh approximation. Real-checkpoint parity
    # requires honoring the checkpoint's own activation.
    hidden_act: str = "gelu"
    # bf16 products with f32 accumulation are the fast path; float32 is
    # for tight numerical comparisons.
    compute_dtype: str = "bfloat16"

    @staticmethod
    def tiny() -> "BertConfig":
        """Small config for tests (runs on CPU in milliseconds)."""
        return BertConfig(
            vocab_size=1024, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128, max_position_embeddings=128,
        )

    @staticmethod
    def from_hf_config(path: str) -> "BertConfig":
        with open(path, "r", encoding="utf-8") as f:
            cfg = json.load(f)
        return BertConfig(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            intermediate_size=cfg["intermediate_size"],
            max_position_embeddings=cfg.get("max_position_embeddings", 512),
            type_vocab_size=cfg.get("type_vocab_size", 2),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
            hidden_act=cfg.get("hidden_act", "gelu"),
        )


# ---------------------------------------------------------------- params

_DENSE = ("q", "k", "v", "attn_out", "ffn_in", "ffn_out")
_NORMS = ("attn_ln", "ffn_ln")


def init_params(config: BertConfig, seed: int = 0) -> Dict[str, Any]:
    """Random weights as the reference's pytree of numpy arrays: the same
    numpy draws in the same order, so a seed gives the same weights."""
    rng = np.random.default_rng(seed)
    h, i = config.hidden_size, config.intermediate_size

    def dense(n_in, n_out):
        scale = 1.0 / math.sqrt(n_in)
        return {
            "kernel": rng.normal(0, scale, (n_in, n_out)).astype(np.float32),
            "bias": np.zeros(n_out, np.float32),
        }

    def ln():
        return {"scale": np.ones(h, np.float32), "bias": np.zeros(h, np.float32)}

    params: Dict[str, Any] = {
        "embeddings": {
            "word": rng.normal(0, 0.02, (config.vocab_size, h)).astype(np.float32),
            "position": rng.normal(
                0, 0.02, (config.max_position_embeddings, h)
            ).astype(np.float32),
            "token_type": rng.normal(
                0, 0.02, (config.type_vocab_size, h)
            ).astype(np.float32),
            "ln": ln(),
        },
        "layers": [],
    }
    for _ in range(config.num_layers):
        params["layers"].append({
            "q": dense(h, h), "k": dense(h, h), "v": dense(h, h),
            "attn_out": dense(h, h), "attn_ln": ln(),
            "ffn_in": dense(h, i), "ffn_out": dense(i, h), "ffn_ln": ln(),
        })
    return params


def load_hf_params(model_dir: str, config: BertConfig) -> Dict[str, Any]:
    """Load a bert-base-style HuggingFace checkpoint (model.safetensors
    preferred, pytorch_model.bin otherwise) into the pytree of numpy
    arrays that `init_params` returns."""
    st_path = os.path.join(model_dir, "model.safetensors")
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    tensors = None
    if os.path.exists(st_path):
        try:
            from safetensors.numpy import load_file

            tensors = load_file(st_path)
        except ImportError:
            tensors = None
    if tensors is None:
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        tensors = {k: v.numpy() for k, v in sd.items()}

    def t(name):
        for prefix in ("", "bert."):
            key = prefix + name
            if key in tensors:
                return np.asarray(tensors[key], dtype=np.float32)
        raise KeyError(name)

    def dense(stem):
        return {"kernel": t(stem + ".weight").T, "bias": t(stem + ".bias")}

    def ln(stem):
        return {"scale": t(stem + ".weight"), "bias": t(stem + ".bias")}

    params: Dict[str, Any] = {
        "embeddings": {
            "word": t("embeddings.word_embeddings.weight"),
            "position": t("embeddings.position_embeddings.weight"),
            "token_type": t("embeddings.token_type_embeddings.weight"),
            "ln": ln("embeddings.LayerNorm"),
        },
        "layers": [],
    }
    for layer in range(config.num_layers):
        stem = f"encoder.layer.{layer}"
        params["layers"].append({
            "q": dense(f"{stem}.attention.self.query"),
            "k": dense(f"{stem}.attention.self.key"),
            "v": dense(f"{stem}.attention.self.value"),
            "attn_out": dense(f"{stem}.attention.output.dense"),
            "attn_ln": ln(f"{stem}.attention.output.LayerNorm"),
            "ffn_in": dense(f"{stem}.intermediate.dense"),
            "ffn_out": dense(f"{stem}.output.dense"),
            "ffn_ln": ln(f"{stem}.output.LayerNorm"),
        })
    return params


def _param(a: np.ndarray) -> nn.Parameter:
    return nn.Parameter(
        torch.from_numpy(np.array(a, dtype=np.float32)), requires_grad=False)


class BertParams(nn.Module):
    """The encoder's weights as module parameters (float32, no
    gradients). Names follow the pytree: `embeddings["word"]`,
    `layers[i]["q_kernel"]` ([in, out], as stored there),
    `layers[i]["attn_ln_scale"]`."""

    def __init__(self, params: Dict[str, Any]):
        super().__init__()
        emb = params["embeddings"]
        self.embeddings = nn.ParameterDict({
            "word": _param(emb["word"]),
            "position": _param(emb["position"]),
            "token_type": _param(emb["token_type"]),
            "ln_scale": _param(emb["ln"]["scale"]),
            "ln_bias": _param(emb["ln"]["bias"]),
        })
        self.layers = nn.ModuleList()
        for layer in params["layers"]:
            entries = {}
            for name in _DENSE:
                entries[name + "_kernel"] = _param(layer[name]["kernel"])
                entries[name + "_bias"] = _param(layer[name]["bias"])
            for name in _NORMS:
                entries[name + "_scale"] = _param(layer[name]["scale"])
                entries[name + "_bias"] = _param(layer[name]["bias"])
            self.layers.append(nn.ParameterDict(entries))
        # bf16-rounded kernels, made at the first bf16 forward
        self._rounded: Dict[Tuple[int, str, bool], torch.Tensor] = {}

    def rounded_kernel(self, i: int, name: str, keep_bf16: bool) -> torch.Tensor:
        """Layer i's dense kernel rounded to bf16: as bf16 where the
        product takes bf16 operands, else widened back to float32."""
        key = (i, name, keep_bf16)
        w = self._rounded.get(key)
        if w is None or w.device != self.layers[i][name + "_kernel"].device:
            w = self.layers[i][name + "_kernel"].detach().to(torch.bfloat16)
            w = w if keep_bf16 else w.float()
            self._rounded[key] = w
        return w


def params_from_reference(params: Dict[str, Any],
                          device: DeviceLike = None) -> BertParams:
    """The reference's parameter pytree (numpy or anything `np.asarray`
    takes) -> a `BertParams` module on `device`."""
    return BertParams(params).to(resolve_device(device))


# ---------------------------------------------------------------- forward

@functools.lru_cache(maxsize=None)
def _bmm_has_out_dtype() -> bool:
    """Whether this PyTorch's `torch.bmm` takes `out_dtype` (a float32
    result from bf16 operands on CUDA)."""
    z = torch.zeros((1, 1, 1), dtype=torch.bfloat16, device="cuda")
    try:
        torch.bmm(z, z, out_dtype=torch.float32)
    except TypeError:
        return False
    return True


def _bf16_operands(device: torch.device) -> bool:
    """True where `_mm` multiplies bf16 tensors into a float32 result."""
    return device.type == "cuda" and _bmm_has_out_dtype()


def _mm(a: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    """Batched [N, I, K] x [N, K, J] -> float32 [N, I, J]. With `bf16`
    both operands are rounded to bf16 first and the sum stays float32."""
    if not bf16:
        return torch.bmm(a.float(), b.float())
    if _bf16_operands(a.device):
        return torch.bmm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                         out_dtype=torch.float32)
    return torch.bmm(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())


def _layer_norm(x, scale, bias, eps):
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale + bias


def bert_forward(
    params: BertParams,
    token_ids: torch.Tensor,       # [B, T] int
    attention_mask: torch.Tensor,  # [B, T] (1 = real token)
    config: BertConfig,
) -> torch.Tensor:
    """Returns pooled sentence embeddings [B, H] float32 (masked mean
    pooling + optional L2 norm)."""
    b, tlen = token_ids.shape
    h = config.hidden_size
    heads = config.num_heads
    head_dim = h // heads
    mask = attention_mask.to(torch.float32)
    bf16 = config.compute_dtype == "bfloat16"
    gelu = ("tanh" if config.hidden_act in ("gelu_new", "gelu_pytorch_tanh")
            else "none")
    eps = config.layer_norm_eps
    keep = bf16 and _bf16_operands(token_ids.device)

    def dense(x, i, name):
        layer = params.layers[i]
        w = (params.rounded_kernel(i, name, keep) if bf16
             else layer[name + "_kernel"])
        lead = x.shape[:-1]
        out = _mm(x.reshape(1, -1, x.shape[-1]), w[None], bf16)
        return out.reshape(*lead, w.shape[1]) + layer[name + "_bias"]

    def heads_first(x):    # [B, T, H] -> [B * heads, T, head_dim]
        return x.reshape(b, tlen, heads, head_dim).permute(0, 2, 1, 3).reshape(
            b * heads, tlen, head_dim)

    emb = params.embeddings
    x = (
        emb["word"][token_ids.long()]
        + emb["position"][:tlen][None, :, :]
        + emb["token_type"][0]
    )
    x = _layer_norm(x, emb["ln_scale"], emb["ln_bias"], eps)

    # additive attention bias: -1e9 on padding keys
    att_bias = ((1.0 - mask) * -1e9)[:, None, None, :]

    for i, layer in enumerate(params.layers):
        q, k, v = (heads_first(dense(x, i, n)) for n in ("q", "k", "v"))
        scores = torch.bmm(q, k.transpose(1, 2)) / math.sqrt(head_dim)
        probs = torch.softmax(
            scores.reshape(b, heads, tlen, tlen) + att_bias, dim=-1)
        ctx = _mm(probs.reshape(b * heads, tlen, tlen), v, bf16)
        ctx = ctx.reshape(b, heads, tlen, head_dim).permute(0, 2, 1, 3).reshape(
            b, tlen, h)
        x = _layer_norm(x + dense(ctx, i, "attn_out"), layer["attn_ln_scale"],
                        layer["attn_ln_bias"], eps)
        y = torch.nn.functional.gelu(dense(x, i, "ffn_in"), approximate=gelu)
        x = _layer_norm(x + dense(y, i, "ffn_out"), layer["ffn_ln_scale"],
                        layer["ffn_ln_bias"], eps)

    # masked mean pool
    denom = mask.sum(dim=1, keepdim=True).clamp_min(1.0)
    pooled = (x * mask[:, :, None]).sum(dim=1) / denom
    if config.normalize_output:
        pooled = pooled / (
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True) + 1e-12)
    return pooled


# ---------------------------------------------------------------- tokenizers


class HashTokenizer:
    """Deterministic fallback tokenizer: whitespace words hashed (md5)
    into a fixed vocab. Hermetic; used for tests and when no HF tokenizer
    files are available."""

    def __init__(self, vocab_size: int = 1024, max_length: int = 128):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.cls_id = 1
        self.sep_id = 2

    def encode_batch(self, texts) -> Tuple[np.ndarray, np.ndarray]:
        rows = []
        for text in texts:
            ids = [self.cls_id]
            for word in text.lower().split()[: self.max_length - 2]:
                digest = hashlib.md5(word.encode("utf-8")).digest()
                ids.append(
                    3 + int.from_bytes(digest[:4], "little") % (self.vocab_size - 3)
                )
            ids.append(self.sep_id)
            rows.append(ids)
        t = max(len(r) for r in rows)
        out = np.zeros((len(rows), t), dtype=np.int32)
        mask = np.zeros((len(rows), t), dtype=np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return out, mask


class HfTokenizer:
    """transformers tokenizer from a local directory (no network)."""

    def __init__(self, model_dir: str, max_length: int = 256):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(model_dir)
        self.max_length = max_length

    def encode_batch(self, texts) -> Tuple[np.ndarray, np.ndarray]:
        enc = self.tok(
            list(texts), padding=True, truncation=True,
            max_length=self.max_length, return_tensors="np",
        )
        return (
            enc["input_ids"].astype(np.int32),
            enc["attention_mask"].astype(np.int32),
        )


# ---------------------------------------------------------------- encoder


def _bucket_len(t: int, floor: int = 16, cap: int = 512) -> int:
    size = floor
    while size < t and size < cap:
        size *= 2
    return min(size, cap)


def _bucket_batch(b: int, floor: int = 8) -> int:
    size = floor
    while size < b:
        size *= 2
    return size


class BertEncoder:
    """Host-facing encoder: tokenize, bucket, forward on `device`
    (default cuda). Batch and length are padded to the reference's
    power-of-two buckets so that padded rows see the same masks."""

    def __init__(
        self,
        config: Optional[BertConfig] = None,
        model_dir: Optional[str] = None,
        max_length: int = 256,
        seed: int = 0,
        compute_dtype: Optional[str] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if model_dir:
            if not os.path.isdir(model_dir):
                raise RuntimeError(
                    f"{model_dir!r} is not a local checkpoint directory; "
                    "fetching a checkpoint by its hub name is not ported "
                    "(it downloads). Pass a directory holding config.json, "
                    "model.safetensors or pytorch_model.bin, and the "
                    "tokenizer files.")
            hf_cfg = os.path.join(model_dir, "config.json")
            self.config = (
                BertConfig.from_hf_config(hf_cfg)
                if os.path.exists(hf_cfg)
                else (config or BertConfig())
            )
            # A checkpoint dir that fails to load must hard-fail: falling
            # back to random weights would make a pruned index quietly
            # return garbage embeddings.
            try:
                weights = load_hf_params(model_dir, self.config)
            except Exception as e:
                raise RuntimeError(
                    f"failed to load model weights from {model_dir!r}: {e}. "
                    "Expected model.safetensors or pytorch_model.bin with "
                    "BERT-style parameter names."
                ) from e
            try:
                self.tokenizer = HfTokenizer(model_dir, max_length)
            except Exception as e:
                # never pair real weights with the hash tokenizer
                raise RuntimeError(
                    f"failed to load tokenizer from {model_dir!r}: {e}. "
                    "A tokenizer.json / vocab.txt matching the checkpoint "
                    "is required when real weights are used."
                ) from e
        else:
            self.config = config or BertConfig.tiny()
            weights = init_params(self.config, seed)
            self.tokenizer = HashTokenizer(self.config.vocab_size, max_length)
        if compute_dtype is not None:
            self.config = dataclasses.replace(
                self.config, compute_dtype=compute_dtype)
        self.max_length = min(max_length, self.config.max_position_embeddings)
        self.params = params_from_reference(weights, self.device)

    @property
    def dimensions(self) -> int:
        return self.config.hidden_size

    def encode_tokens(
        self, token_ids: np.ndarray, attention_mask: np.ndarray
    ) -> np.ndarray:
        with torch.no_grad():
            out = bert_forward(
                self.params,
                torch.from_numpy(np.ascontiguousarray(token_ids)).to(self.device),
                torch.from_numpy(
                    np.ascontiguousarray(attention_mask)).to(self.device),
                self.config)
        return out.cpu().numpy()

    def embed(self, texts, batch_size: int = 128) -> np.ndarray:
        out = []
        for i in range(0, len(texts), batch_size):
            chunk = texts[i : i + batch_size]
            ids, mask = self.tokenizer.encode_batch(chunk)
            b, t = ids.shape
            tb = _bucket_len(t, cap=self.max_length)
            bb = _bucket_batch(b)
            ids2 = np.zeros((bb, tb), np.int32)
            mask2 = np.zeros((bb, tb), np.int32)
            ids2[:b, : min(t, tb)] = ids[:, :tb]
            mask2[:b, : min(t, tb)] = mask[:, :tb]
            out.append(self.encode_tokens(ids2, mask2)[:b])
        return np.concatenate(out, axis=0) if out else np.zeros((0, self.dimensions), np.float32)

    def tokenize_corpus(
        self, texts, max_length: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed-width token matrix for the on-device token store
        (pruned-index recompute)."""
        t = max_length or self.max_length
        ids_list, mask_list = self.tokenizer.encode_batch(texts)
        n, cur = ids_list.shape
        out = np.zeros((n, t), np.int32)
        mask = np.zeros((n, t), np.int32)
        w = min(cur, t)
        out[:, :w] = ids_list[:, :w]
        mask[:, :w] = mask_list[:, :w]
        return out, mask
