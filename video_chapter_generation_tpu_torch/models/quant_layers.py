"""Weight-only int8 layers for serving the title model (counterpart of
the JAX package's models/quant_layers.py).

Decode reads every decoder matrix and the tied head for a few rows of
activations, so storing the weights as int8 with a float scale per
output channel halves what a step streams. The JAX package leaves the
product to XLA (an int8 -> bf16 convert fused into the matmul, :55-67);
here it is a torch.matmul on the weights cast to the activation dtype.
Activations stay in the model dtype (W8A16). `ops/quantize.py:
quantize_seq2seq` makes the state dict these modules load.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def quantize_weight(w: torch.Tensor, axis: int = 0):
    """Per-channel symmetric int8 of a 2-d float matrix, reduced over
    `axis` (quant_layers.py:29): scale = max(amax, 1e-8) / 127, q =
    clip(round(w / scale), -127, 127). Returns (q int8, scale float32).
    (ops/tsm_block_int8.py:quantize_weight is another function: it clamps
    the scale after the division, at 1e-12.)"""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=axis), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale


class Int8Linear(nn.Module):
    """nn.Linear with an int8 weight [out, in] and a float32 scale [out]:
    y = (x @ weight_q^T) * scale + bias, in x's dtype; bias=False (the
    JAX Int8Dense's use_bias, :43-66) leaves the bias out, as BigBird's
    attention projections do."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(
            out_features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = F.linear(x, self.weight_q.to(dt)) * self.scale.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class Int8Embed(nn.Module):
    """The tied Pegasus table as int8 [V, D] with a float scale per vocab
    row: lookup rows * scale, and the head's logits (hidden @ table^T) *
    scale. Lookups come out in the scale's dtype, which follows the
    model's (a module .to(dtype) casts it, never the int8 table)."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.register_buffer("embedding_q", torch.zeros(
            num_embeddings, features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(num_embeddings))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        dt = self.scale.dtype
        return self.embedding_q[ids].to(dt) * self.scale[ids][..., None]

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        dt = hidden.dtype
        return (hidden @ self.embedding_q.t().to(dt)) * self.scale.to(dt)
