"""BERT encoder with pooler, and BertForChapter with its chapter and MLM
heads (counterpart of the JAX package's models/bert.py). Module names
follow HuggingFace's `BertModel`, so the JAX package's `convert_hf_bert`
reads this state dict as it is (BertForChapter's under `base_model.`).

In train() mode the hidden and attention dropouts of the JAX package
(rates 0.1, models/bert.py:35-36) are active, drawn from the
torch.Generator the caller passes (the default generator when none)."""

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
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1

    @classmethod
    def tiny(cls, vocab_size: int = 128) -> "BertConfig":
        return cls(vocab_size=vocab_size, hidden_size=32, num_layers=2,
                   num_heads=2, intermediate_size=64,
                   max_position_embeddings=64)


def dropout(x: torch.Tensor, p: float, on: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with an explicit generator: keep with 1 - p and
    scale by 1 / (1 - p); identity when off or p == 0."""
    if not on or p <= 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h,
                                            padding_idx=cfg.pad_token_id)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, input_ids, token_type_ids, input_embeds=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        words = (self.word_embeddings(input_ids) if input_embeds is None
                 else input_embeds)
        emb = (words + self.position_embeddings(pos)[None]
               + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(emb)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.attention_dropout = cfg.attention_dropout
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)

    def forward(self, hidden, bias, gen=None):
        b, l, d = hidden.shape
        split = lambda t: t.reshape(b, l, self.num_heads, -1).transpose(1, 2)  # noqa: E731
        q, k, v = (split(self.query(hidden)), split(self.key(hidden)),
                   split(self.value(hidden)))
        scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        if scores.dtype != torch.float64:  # softmax in at least float32
            scores = scores.float()
        probs = torch.softmax(scores + bias, dim=-1).to(v.dtype)
        probs = dropout(probs, self.attention_dropout, self.training, gen)
        return (probs @ v).transpose(1, 2).reshape(b, l, d)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.hidden_dropout = cfg.hidden_dropout
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ctx, hidden, gen=None):
        out = dropout(self.dense(ctx), self.hidden_dropout, self.training, gen)
        return self.LayerNorm(out + hidden)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, hidden, bias, gen=None):
        return self.output(self.self(hidden, bias, gen), hidden, gen)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x))  # exact (erf) gelu


class BertOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.hidden_dropout = cfg.hidden_dropout
        self.dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, inter, attn, gen=None):
        out = dropout(self.dense(inter), self.hidden_dropout, self.training,
                      gen)
        return self.LayerNorm(out + attn)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, hidden, bias, gen=None):
        attn = self.attention(hidden, bias, gen)
        return self.output(self.intermediate(attn), attn, gen)


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
    (last hidden state [B, L, H], pooled output [B, H]).

    input_embeds [B, L, H] replaces the word-embedding lookup of
    input_ids (the JAX package's models/bert.py:110-122; saliency and
    integrated gradients differentiate through it); the position and
    token-type embeddings are added to it all the same."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)
        self.pooler = BertPooler(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                input_embeds: Optional[torch.Tensor] = None):
        """generator drives the dropout masks in train() mode."""
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        hidden = self.embeddings(input_ids, token_type_ids, input_embeds)
        hidden = dropout(hidden, self.cfg.hidden_dropout, self.training,
                         generator)
        # additive mask [B, 1, 1, L]: 0 keeps, -10000 drops a pad key
        bias = (1.0 - attention_mask[:, None, None, :].float()) * -10000.0
        for layer in self.encoder.layer:
            hidden = layer(hidden, bias, generator)
        return hidden, self.pooler(hidden)


class BertForChapter(nn.Module):
    """The reference's BertHugface (JAX models/bert.py:152-191): a 2-way
    chapter head over the pooled output, or with pretrain_stage the
    bias-free vocabulary (MLM) head over every position.

    forward(text_ids [B, L], attention_mask [B, L]) -> (logits, probs):
    [B, 2] or [B, L, vocab]; probs the softmax in at least float32."""

    def __init__(self, cfg: BertConfig, pretrain_stage: bool = False):
        super().__init__()
        self.cfg = cfg
        self.pretrain_stage = pretrain_stage
        self.base_model = BertModel(cfg)
        self.head = (nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
                     if pretrain_stage else nn.Linear(cfg.hidden_size, 2))

    def forward(self, text_ids: torch.Tensor, attention_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                input_embeds: Optional[torch.Tensor] = None):
        hidden, pooled = self.base_model(text_ids, attention_mask,
                                         generator=generator,
                                         input_embeds=input_embeds)
        logits = self.head(hidden if self.pretrain_stage else pooled)
        probs = torch.softmax(
            logits.to(torch.promote_types(logits.dtype, torch.float32)), -1)
        return logits, probs
