"""More fusion models (counterpart of the JAX package's
models/fusion_variants.py).

- TwoStreamDomainSpecific (JAX :143-184): BERT and ResNet-TSM streams as
  in TwoStreamWindow, then DomainSpecificChapterHead: per-position
  projections, the vision mean-pooled over the segment, a window
  self-attention per modality (DSWindowSelfAttention) and the centre
  clip's two vectors concatenated into a deep classifier
  (two_stream_domain_specific.py:9-483).
- SingleBlockWindowClassifier (JAX :187-244): one pre-norm block whose
  attention query is the middle clip only, over fused window vectors
  (window_self_attention.py:10-206).

Parameter names are the JAX package's (models/convert.py maps them). The
flax LayerNorms here keep flax's default epsilon, 1e-6 (the stacked
projection MLPs' norms, StackedLayerNorm, use 1e-5 as in models/
fusion.py); GELU is exact; the relative clip position is made in the
compute type. Dropout is active in train() mode and draws from the
torch.Generator the caller passes; a module built with p = 0 runs none,
its fixed-rate dropouts (0.1, 0.25, 0.15 as in the JAX modules) too: the
JAX modules' deterministic=True.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .bert import BertModel, dropout
from .fusion import StackedMLP, WindowModel
from .resnet import ResNet

FLAX_LN_EPS = 1e-6  # flax.linen.LayerNorm's default epsilon


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=FLAX_LN_EPS)


def _rel_positions(s: int, like: torch.Tensor) -> torch.Tensor:
    """[s, 1] clip positions relative to the middle one, in like's dtype
    (JAX :50, :201)."""
    middle = s // 2
    return ((torch.arange(s, dtype=like.dtype, device=like.device) - middle)
            / (middle + 1e-6))[:, None]


class DSWindowSelfAttention(nn.Module):
    """Domain-specific window self-attention (two_stream_domain_specific
    .py:9-134; JAX :26-87): position MLP and its LayerNorm, pre-LN, a full
    [W x W] per-head bias (sliced to the window), a deep out-projection
    ([2H LN ReLU Dropout] x 3 -> H)."""

    def __init__(self, hidden_size: int, num_heads: int = 16,
                 window_size: int = 1, p: float = 0.1):
        super().__init__()
        h, w = hidden_size, 2 * window_size + 1
        self.num_heads, self.p = num_heads, p
        self.position_encoding = nn.Linear(1, h)
        self.position_ln = _ln(h)
        self.norm = _ln(h)
        self.query_proj = nn.Linear(h, h)
        self.key_proj = nn.Linear(h, h)
        self.value_proj = nn.Linear(h, h)
        self.window_pos_bias = nn.Parameter(torch.zeros(1, num_heads, w, w))
        for i in range(3):
            self.add_module(f"out{i}", nn.Linear(h if i == 0 else 2 * h,
                                                 2 * h))
            self.add_module(f"out_ln{i}", _ln(2 * h))
        self.out_final = nn.Linear(2 * h, h)

    def forward(self, x, generator=None):
        b, s, h = x.shape
        nh, on = self.num_heads, self.training and self.p > 0
        hd = h // nh
        pos = self.position_ln(self.position_encoding(_rel_positions(s, x)))
        x = x + dropout(pos, self.p, on, generator)[None]
        y = self.norm(x)
        q, k, v = (m(y).reshape(b, s, nh, hd)
                   for m in (self.query_proj, self.key_proj, self.value_proj))
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(hd))
        att = att + self.window_pos_bias.to(att.dtype)[:, :, :s, :s]
        att = dropout(torch.softmax(att, dim=-1), self.p, on, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, s, h)
        for i in range(3):
            out = getattr(self, f"out_ln{i}")(getattr(self, f"out{i}")(out))
            out = dropout(torch.relu(out), 0.1, on, generator)
        return dropout(self.out_final(out), self.p, on, generator)


class DomainSpecificChapterHead(nn.Module):
    """two_stream_domain_specific.py:239-370 (JAX :90-140): per-position
    projections, the vision mean-pooled over the segment after its
    projection, separate lang and vision window attention, the centre
    clip's vectors concatenated -> [Dense LN ReLU Dropout] x 4 -> logits.

    forward(lang_embs [B, W, lang_dim], vision_embs [B, W, seg,
    vision_dim]) -> logits [B, output_size]."""

    def __init__(self, num_clips: int, segment_size: int, hidden_size: int,
                 window_size: int, output_size: int = 2,
                 lang_dim: int = 768, vision_dim: int = 2048,
                 p: float = 0.1):
        super().__init__()
        h, w = hidden_size, num_clips
        self.seg, self.h, self.p = segment_size, h, p
        self.lang_proj_heads = StackedMLP(w, lang_dim, (lang_dim // 2, h), p)
        self.vision_proj_heads = StackedMLP(w, vision_dim, (8 * h, 4 * h, h),
                                            p)
        self.lang_window_attn = DSWindowSelfAttention(h, 16, window_size, p)
        self.vision_window_attn = DSWindowSelfAttention(h, 16, window_size, p)
        dims = (2 * h, 2 * h, h, h // 2, h // 4)
        for i in range(4):
            self.add_module(f"cls{i}", nn.Linear(dims[i], dims[i + 1]))
            self.add_module(f"cls_ln{i}", _ln(dims[i + 1]))
        self.classifier = nn.Linear(h // 4, output_size)

    def forward(self, lang_embs, vision_embs, generator=None):
        b, w, _ = lang_embs.shape
        h, seg = self.h, self.seg
        lang = torch.relu(self.lang_proj_heads(lang_embs, generator))
        ve = vision_embs.transpose(1, 2).reshape(b * seg, w, -1)
        vision = torch.relu(self.vision_proj_heads(ve, generator))
        vision = vision.reshape(b, seg, w, h).mean(dim=1)  # pool segments
        lang_att = self.lang_window_attn(lang, generator)
        vision_att = self.vision_window_attn(vision, generator)
        center = w // 2
        y = torch.cat([lang_att[:, center], vision_att[:, center]], dim=-1)
        for i in range(4):
            y = getattr(self, f"cls_ln{i}")(getattr(self, f"cls{i}")(y))
            y = dropout(torch.relu(y), 0.1, self.training and self.p > 0,
                        generator)
        return self.classifier(y)


class TwoStreamDomainSpecific(WindowModel):
    """The domain-specific window model: DomainSpecificChapterHead on the
    two streams, batched as TwoStreamWindow (WindowModel)."""

    def __init__(self, lang_model: BertModel, vision_model: ResNet,
                 window_size: int = 1, segment_size: int = 16,
                 hidden_size: int = 128, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.1):
        super().__init__(lang_model, vision_model, window_size, segment_size,
                         dtype)
        self.fusion_head = DomainSpecificChapterHead(
            self.num_clips, segment_size, hidden_size, window_size,
            lang_dim=lang_model.cfg.hidden_size,
            vision_dim=vision_model.feature_dim, p=dropout)

    def head(self, lang, vision, generator=None):
        logits = self.fusion_head(lang, vision, generator)
        return logits, torch.softmax(
            logits.to(torch.promote_types(logits.dtype, torch.float32)), -1)


class SingleBlockWindowClassifier(nn.Module):
    """window_self_attention.py:28-206 (JAX :187-244): one pre-norm block,
    the attention query the middle clip only; FFN (Dropout, H -> 4H,
    GELU, Dropout .25, 4H -> H, Dropout .15); classifier LN -> H/2 -> GELU
    -> Dropout -> 2.

    forward(fusion_emb [B, W, H]) -> (logits [B, 2], probs [B, 2])."""

    def __init__(self, hidden_size: int, num_heads: int = 16,
                 window_size: int = 1, p: float = 0.1):
        super().__init__()
        h = hidden_size
        self.num_heads, self.p = num_heads, p
        self.attention_norm = _ln(h)
        self.position_encoding = nn.Linear(1, h)
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.window_pos_bias = nn.Parameter(
            torch.zeros(1, num_heads, 1, 2 * window_size + 1))
        self.out_proj = nn.Linear(h, h)
        self.ffn_norm = _ln(h)
        self.ffn_fc1 = nn.Linear(h, 4 * h)
        self.ffn_fc2 = nn.Linear(4 * h, h)
        self.cls_ln = _ln(h)
        self.cls_fc1 = nn.Linear(h, h // 2)
        self.cls_fc2 = nn.Linear(h // 2, 2)

    def forward(self, fusion_emb, generator=None):
        b, s, h = fusion_emb.shape
        nh, on = self.num_heads, self.training and self.p > 0
        hd = h // nh
        middle = s // 2
        residual = fusion_emb[:, middle:middle + 1]
        y = self.attention_norm(fusion_emb)
        y = y + self.position_encoding(_rel_positions(s, y))[None]
        q = self.query(y[:, middle:middle + 1]).reshape(b, 1, nh, hd)
        k = self.key(y).reshape(b, s, nh, hd)
        v = self.value(y).reshape(b, s, nh, hd)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        att = att + self.window_pos_bias.to(att.dtype)[..., :s]
        att = dropout(torch.softmax(att, dim=-1), self.p, on, generator)
        ctx = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, 1, h)
        x = self.out_proj(ctx) + residual
        y = dropout(self.ffn_norm(x), 0.1, on, generator)
        y = dropout(F.gelu(self.ffn_fc1(y)), 0.25, on, generator)
        y = dropout(self.ffn_fc2(y), 0.15, on, generator)
        x = y + x
        y = F.gelu(self.cls_fc1(self.cls_ln(x[:, 0])))
        logits = self.cls_fc2(dropout(y, 0.1, on, generator))
        return logits, torch.softmax(
            logits.to(torch.promote_types(logits.dtype, torch.float32)), -1)
