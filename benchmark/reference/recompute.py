"""Plain pruned-recompute reference: the encoder's forward at the
configuration's stated arithmetic, its hash tokenizer and its seeded
weights, written again from their rules: the yardstick of the recompute
cell, with `exact.topk` for the exact top-k over what it embeds.

Plain PyTorch and numpy with TF32 off (`no_tf32`); imports nothing of
the program.

Arithmetic (`compute_dtype` bfloat16, the configuration's): both
operands of every dense product (q, k, v, the attention output, the
FFN's two) and of the context product (probabilities x v) are rounded to
bfloat16 and multiplied in float32; the score product q k^T takes its
float32 operands unrounded; everything else is float32. Two controls
(`low`):
  - "fp8": the stated arithmetic one precision lower, the operands that
    it rounds to bf16 rounded to float8 e4m3 instead, each tensor scaled
    so that its largest magnitude is e4m3's largest (448): the H100's
    next operand precision below bf16;
  - "bf16": every product, the score product too, takes bf16-rounded
    operands and has its result rounded to bf16, as a bf16 matrix
    product returns it.

Departures from the published BERT (Devlin et al. 2019, as
HuggingFace's `BertModel` computes it):
  - the bf16 rounding above, which is the configuration's precision;
  - inference: no dropout; token type 0 at every position;
  - the sentence embedding is the attention-masked mean of the last
    layer's states, L2-normalised (norm + 1e-12), as Contriever pools,
    in place of BERT's [CLS] pooler;
  - padding keys get an additive -1e9 (HuggingFace: the dtype's least
    value): their softmax weight is exactly 0 in float32 either way;
  - a block of rows is computed at its longest real length, not at the
    stored width: padded positions take no part (weight 0 as keys, left
    out of the pool), so the result is the same up to the order of
    float32 sums.

Tokenizer (the program's hash tokenizer, by its rule): [CLS] = 1, then
each lowercased whitespace-separated word, at most `max_length` - 2, as
3 + (the first 4 bytes of its md5, little-endian) mod (vocab - 3), then
[SEP] = 2; 0 past the end.

Weights (`init_weights`): numpy's `default_rng(seed)` draws, in this
order: the word [V, H], position [P, H] and token-type [2, H] embeddings
~ N(0, 0.02); then per layer the kernels, stored [in, out], of q, k, v,
the attention output (H x H), the FFN's input (H x F) and output
(F x H), each ~ N(0, 1 / sqrt(in)); every bias 0, every layer norm's
scale 1 and bias 0.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DENSE = ("q", "k", "v", "attn_out", "ffn_in", "ffn_out")


def no_tf32() -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def tokenize(texts: Sequence[str], vocab_size: int,
             max_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """(ids int64 [n, max_length], real lengths int64 [n])."""
    ids = np.zeros((len(texts), max_length), np.int64)
    lengths = np.zeros(len(texts), np.int64)
    for i, text in enumerate(texts):
        row = [1]
        for word in text.lower().split()[:max_length - 2]:
            digest = hashlib.md5(word.encode("utf-8")).digest()
            row.append(3 + int.from_bytes(digest[:4], "little")
                       % (vocab_size - 3))
        row.append(2)
        ids[i, :len(row)] = row
        lengths[i] = len(row)
    return ids, lengths


def init_weights(enc: Dict, seed: int, device) -> Dict:
    """The encoder's weights drawn from `seed` (the rule above), float32
    tensors on `device`. `enc` holds the widths: `vocab_size`,
    `hidden_size`, `num_layers`, `intermediate_size`,
    `max_position_embeddings`, `type_vocab_size`."""
    import torch

    rng = np.random.default_rng(seed)
    h, f = enc["hidden_size"], enc["intermediate_size"]

    def normal(scale, shape):
        return torch.from_numpy(
            rng.normal(0, scale, shape).astype(np.float32)).to(device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    w = {"word": normal(0.02, (enc["vocab_size"], h)),
         "position": normal(0.02, (enc["max_position_embeddings"], h)),
         "token_type": normal(0.02, (enc["type_vocab_size"], h)),
         "ln": (ones(h), zeros(h)), "layers": []}
    shapes = {"q": (h, h), "k": (h, h), "v": (h, h), "attn_out": (h, h),
              "ffn_in": (h, f), "ffn_out": (f, h)}
    for _ in range(enc["num_layers"]):
        layer = {}
        for name in DENSE:
            n_in, n_out = shapes[name]
            layer[name] = (normal(1.0 / math.sqrt(n_in), (n_in, n_out)),
                           zeros(n_out))
        layer["attn_ln"] = (ones(h), zeros(h))
        layer["ffn_ln"] = (ones(h), zeros(h))
        w["layers"].append(layer)
    return w


def _bf16(x):
    import torch

    return x.to(torch.bfloat16).float()


def _fp8(x):
    """x rounded to float8 e4m3 at a per-tensor scale (amax -> 448)."""
    import torch

    scale = 448.0 / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _product(a, b, low, round_operands: bool = True):
    """a @ b in float32 (TF32 off): operands bf16-rounded where asked
    (fp8-rounded with `low` "fp8"); with `low` "bf16" the operands and
    the result are bf16-rounded."""
    if low == "fp8":
        if round_operands:
            a, b = _fp8(a), _fp8(b)
        return a @ b
    if low == "bf16" or round_operands:
        a, b = _bf16(a), _bf16(b)
    out = a @ b
    return _bf16(out) if low == "bf16" else out


def _layer_norm(x, scale_bias, eps: float):
    scale, bias = scale_bias
    mean = x.mean(-1, keepdim=True)
    xc = x - mean
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * (1.0 / (var + eps).sqrt()) * scale + bias


def forward(w: Dict, enc: Dict, ids, lengths, low: Optional[str] = None):
    """Sentence embeddings [B, H] float32 of token rows `ids` [B, T] with
    real `lengths` [B] (tensors on one device); `low` a control (above)."""
    import torch

    b, t = ids.shape
    h, heads = enc["hidden_size"], enc["num_heads"]
    hd = h // heads
    eps = enc["layer_norm_eps"]
    mask = (torch.arange(t, device=ids.device)[None, :]
            < lengths[:, None]).float()                          # [B, T]

    def dense(x, layer, name):
        kernel, bias = layer[name]
        return _product(x, kernel, low) + bias

    def split(x):                                   # [B, T, H] -> [B, h, T, d]
        return x.reshape(b, t, heads, hd).transpose(1, 2)

    x = w["word"][ids] + w["position"][:t][None] + w["token_type"][0]
    x = _layer_norm(x, w["ln"], eps)
    key_bias = ((1.0 - mask) * -1e9)[:, None, None, :]
    for layer in w["layers"]:
        q, k, v = (split(dense(x, layer, n)) for n in ("q", "k", "v"))
        scores = _product(q, k.transpose(-1, -2), low,
                          round_operands=False) / math.sqrt(hd)
        probs = torch.softmax(scores + key_bias, dim=-1)
        ctx = _product(probs, v, low).transpose(1, 2).reshape(b, t, h)
        x = _layer_norm(x + dense(ctx, layer, "attn_out"), layer["attn_ln"],
                        eps)
        y = torch.nn.functional.gelu(dense(x, layer, "ffn_in"))
        x = _layer_norm(x + dense(y, layer, "ffn_out"), layer["ffn_ln"], eps)
    pooled = ((x * mask[:, :, None]).sum(1)
              / mask.sum(1, keepdim=True).clamp_min(1.0))
    return pooled / (torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
                     + 1e-12)


def embed(w: Dict, enc: Dict, texts: List[str], max_length: int, device,
          low: Optional[str] = None, rows: int = 4096):
    """Embeddings [n, H] float32 on `device` of `texts`, tokenized at
    `max_length`, in blocks of `rows`, each at its longest real length;
    `low` a control (above)."""
    import torch

    no_tf32()
    ids, lengths = tokenize(texts, enc["vocab_size"], max_length)
    out = []
    with torch.no_grad():
        for s in range(0, len(texts), rows):
            ln = lengths[s:s + rows]
            t = max(1, int(ln.max()))
            out.append(forward(
                w, enc, torch.from_numpy(ids[s:s + rows, :t]).to(device),
                torch.from_numpy(ln).to(device), low))
    return torch.cat(out)
