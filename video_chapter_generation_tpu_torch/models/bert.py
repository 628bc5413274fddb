"""BERT encoder with pooler (counterpart of the JAX package's
models/bert.py). Module names follow HuggingFace's `BertModel`, so the
JAX package's `convert_hf_bert` reads this state dict as it is."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


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
    pad_token_id: int = 0

    @classmethod
    def tiny(cls, vocab_size: int = 128) -> "BertConfig":
        return cls(vocab_size=vocab_size, hidden_size=32, num_layers=2,
                   num_heads=2, intermediate_size=64,
                   max_position_embeddings=64)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h,
                                            padding_idx=cfg.pad_token_id)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, input_ids, token_type_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(pos)[None]
               + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(emb)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)

    def forward(self, hidden, bias):
        b, l, d = hidden.shape
        split = lambda t: t.reshape(b, l, self.num_heads, -1).transpose(1, 2)  # noqa: E731
        q, k, v = (split(self.query(hidden)), split(self.key(hidden)),
                   split(self.value(hidden)))
        scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        probs = torch.softmax(scores.float() + bias, dim=-1).to(v.dtype)
        return (probs @ v).transpose(1, 2).reshape(b, l, d)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ctx, hidden):
        return self.LayerNorm(self.dense(ctx) + hidden)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, hidden, bias):
        return self.output(self.self(hidden, bias), hidden)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x))  # exact (erf) gelu


class BertOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, inter, attn):
        return self.LayerNorm(self.dense(inter) + attn)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, hidden, bias):
        attn = self.attention(hidden, bias)
        return self.output(self.intermediate(attn), attn)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """forward(input_ids [B, L], attention_mask [B, L]) ->
    (last hidden state [B, L, H], pooled output [B, H])."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)
        self.pooler = BertPooler(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None):
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        hidden = self.embeddings(input_ids, token_type_ids)
        # additive mask [B, 1, 1, L]: 0 keeps, -10000 drops a pad key
        bias = (1.0 - attention_mask[:, None, None, :].float()) * -10000.0
        for layer in self.encoder.layer:
            hidden = layer(hidden, bias)
        return hidden, self.pooler(hidden)
