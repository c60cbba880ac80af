"""A plain BERT sentence encoder and brute-force search for the CPU tests
of pruned recompute: plain torch with TF32 off, importing neither
`leann_tpu` nor `leann_tpu_torch`.

The weights are the reference's pytree of numpy arrays (`embeddings`:
`word`, `position`, `token_type`, `ln`; `layers[i]`: dense `q`, `k`,
`v`, `attn_out`, `ffn_in`, `ffn_out` with `kernel` [in, out] and
`bias`, norms `attn_ln`, `ffn_ln` with `scale` and `bias`), so the test
hands over what the program was built from. The forward is written one
sequence and one head at a time, as the published BERT describes it:
token + position + type-0 embeddings and a layer norm; per layer,
scaled dot-product attention over the real tokens only, the output
projection, residual and layer norm, an erf-GELU FFN, residual and
layer norm; then the mean of the real positions, L2-normalised (+1e-12).
With `bf16` (the program's default arithmetic) both operands of the
dense and the context products are rounded to bfloat16 and multiplied
in float32; the score product q k^T is not rounded. Scores are "higher
is better" inner products.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _round(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if bf16 else x


def _norm(x, p, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * _t(p["scale"]) + _t(p["bias"])


def _dense(x, p, bf16):
    return _round(x, bf16) @ _round(_t(p["kernel"]), bf16) + _t(p["bias"])


def encode_one(params, tokens, length: int, heads: int, eps: float = 1e-12,
               bf16: bool = True) -> torch.Tensor:
    """The embedding [H] of one token row, its first `length` positions
    real."""
    no_tf32()
    ids = torch.as_tensor(np.asarray(tokens[:length], dtype=np.int64))
    emb = params["embeddings"]
    x = (_t(emb["word"])[ids] + _t(emb["position"])[:length]
         + _t(emb["token_type"])[0])
    x = _norm(x, emb["ln"], eps)
    h = x.shape[1]
    d = h // heads
    for layer in params["layers"]:
        q, k, v = (_dense(x, layer[n], bf16) for n in ("q", "k", "v"))
        ctx = []
        for j in range(heads):
            cols = slice(j * d, (j + 1) * d)
            att = torch.softmax(q[:, cols] @ k[:, cols].T / math.sqrt(d), -1)
            ctx.append(_round(att, bf16) @ _round(v[:, cols], bf16))
        x = _norm(x + _dense(torch.cat(ctx, 1), layer["attn_out"], bf16),
                  layer["attn_ln"], eps)
        y = _dense(x, layer["ffn_in"], bf16)
        y = 0.5 * y * (1.0 + torch.erf(y / math.sqrt(2.0)))
        x = _norm(x + _dense(y, layer["ffn_out"], bf16), layer["ffn_ln"], eps)
    pooled = x.mean(0)
    return pooled / (torch.sqrt((pooled * pooled).sum()) + 1e-12)


def encode(params, tokens, mask, heads: int, eps: float = 1e-12,
           bf16: bool = True) -> torch.Tensor:
    """Embeddings [N, H] of token rows [N, T] with prefix masks [N, T]."""
    mask = np.asarray(mask)
    return torch.stack([encode_one(params, tokens[i], int(mask[i].sum()),
                                   heads, eps, bf16)
                        for i in range(len(mask))])


def brute_force(queries, corpus, k: int):
    """(ids [B, k] int64, float64 scores [B, k]): the exact top-k inner
    products, ties to the lower id."""
    q = torch.as_tensor(queries).double()
    x = torch.as_tensor(corpus).double()
    scores = q @ x.T
    order = torch.argsort(-scores, dim=1, stable=True)[:, :k]
    return order, torch.gather(scores, 1, order)
