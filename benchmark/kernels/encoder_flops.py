"""The operations of one row through the encoder, and one H100's peak
for them.

A row of `t` token positions through `layers` BERT layers of width
`hidden` and FFN width `intermediate` takes, in its matrix products,
    layers * (8 t hidden^2 + 4 t hidden intermediate + 4 t^2 hidden)
operations: q, k, v and the attention output (2 t hidden^2 each), the
FFN's two products (2 t hidden intermediate each), and the score and
context products (2 t^2 hidden each). The embeddings, layer norms,
softmax, GELU and pooling are left out. bert-base at t = 48: 8.24 GFLOP.
Peak: one H100 SXM's published dense bf16 rate, 989.4 TFLOP/s.
"""

from __future__ import annotations

H100_BF16_FLOPS = 989.4e12


def row_flops(layers: int, hidden: int, intermediate: int, t: int) -> float:
    """Operations of one row's forward at `t` positions."""
    return float(layers * (8 * t * hidden * hidden
                           + 4 * t * hidden * intermediate
                           + 4 * t * t * hidden))
