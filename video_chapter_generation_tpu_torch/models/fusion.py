"""Two-stream fusion models (counterpart of the JAX package's
models/fusion.py): the base ChapterHead (mlp or attn) and TwoStream
(:192-261), and the flagship window model, TwoStreamWindow, with its
WindowChapterHead (five head types) and StackedWindowAttention
(:269-518). The base head's names follow the reference's two_stream.py,
which the JAX package's `convert_base_chapter_head` reads; the window
modules carry the JAX package's own names (models/convert.py maps them).

Per-window-position weights are stacks with a leading window axis, as in
the JAX package: a StackedDense weight is [W, in, out]. LayerNorm eps is
1e-5 and GELU is exact. Dropout (rate 0.1) is active in train() mode and
draws from the torch.Generator the caller passes."""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .bert import BertModel, dropout
from .resnet import ResNet

LN_EPS = 1e-5


# ---------------------------------------------------------------------------
# stacked (per-window-position) primitives (JAX models/fusion.py:37-102)
# ---------------------------------------------------------------------------


class StackedDense(nn.Module):
    """num_stacks independent Dense layers applied positionally:
    [B, W, in] -> [B, W, out], weight [W, in, out], bias [W, out]."""

    def __init__(self, num_stacks: int, in_dim: int, features: int,
                 use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_stacks, in_dim, features))
        self.bias = (nn.Parameter(torch.zeros(num_stacks, features))
                     if use_bias else None)

    def forward(self, x):
        y = torch.einsum("bwi,wio->bwo", x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)[None]
        return y


class StackedLayerNorm(nn.Module):
    """Per-window-position LayerNorm over the last axis: weight and bias
    [W, dim]; mean and (biased) variance over the last axis."""

    def __init__(self, num_stacks: int, dim: int, eps: float = LN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_stacks, dim))
        self.bias = nn.Parameter(torch.zeros(num_stacks, dim))
        self.eps = eps

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight.to(x.dtype)[None] + self.bias.to(x.dtype)[None]


class StackedMLP(nn.Module):
    """Per-position [Dense -> LN -> ReLU -> Dropout]* -> Dense; children
    dense{i} and ln{i}. `features` ends with the output size."""

    def __init__(self, num_stacks: int, in_dim: int, features, p: float):
        super().__init__()
        self.n, self.p = len(features), p
        for i, f in enumerate(features):
            self.add_module(f"dense{i}", StackedDense(num_stacks, in_dim, f))
            if i < self.n - 1:
                self.add_module(f"ln{i}", StackedLayerNorm(num_stacks, f))
            in_dim = f

    def forward(self, x, generator=None):
        for i in range(self.n):
            x = getattr(self, f"dense{i}")(x)
            if i < self.n - 1:
                x = torch.relu(getattr(self, f"ln{i}")(x))
                x = dropout(x, self.p, self.training, generator)
        return x


# ---------------------------------------------------------------------------
# attention heads (JAX models/fusion.py:110-184)
# ---------------------------------------------------------------------------


class SelfAttentionHead(nn.Module):
    """Self-attention over the fusion tokens [vision..., lang], then a
    projection of token 0 (two_stream.py:8-48)."""

    def __init__(self, n_embd: int, n_head: int, output_size: int,
                 p: float = 0.1):
        super().__init__()
        self.n_head, self.p = n_head, p
        self.query = nn.Linear(n_embd, n_embd)
        self.key = nn.Linear(n_embd, n_embd)
        self.value = nn.Linear(n_embd, n_embd)
        self.proj = nn.Linear(n_embd, output_size)

    def forward(self, x, generator=None):
        b, t, c = x.shape
        hd = c // self.n_head
        q, k, v = (m(x).reshape(b, t, self.n_head, hd)
                   for m in (self.query, self.key, self.value))
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        att = dropout(torch.softmax(att, dim=-1), self.p, self.training,
                      generator)
        y = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, t, c)
        return self.proj(y[:, 0])


class CrossAttentionHead(nn.Module):
    """Lang query -> vision keys and values with a learned frame position
    encoding (two_stream_window.py:11-89); frame positions are made in
    float32 and cast to the compute type (JAX :168-169)."""

    def __init__(self, hidden_size: int, num_heads: int = 16,
                 p: float = 0.1):
        super().__init__()
        h = hidden_size
        self.num_heads, self.p = num_heads, p
        self.lang_norm = nn.LayerNorm(h, eps=LN_EPS)
        self.vision_norm = nn.LayerNorm(h, eps=LN_EPS)
        self.frame_pos_encoding = nn.Linear(1, h)
        self.query_proj = nn.Linear(h, h)
        self.key_proj = nn.Linear(h, h)
        self.value_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)

    def forward(self, lang_emb, vision_emb, generator=None):
        b, f, h = vision_emb.shape
        nh = self.num_heads
        hd = h // nh
        lang = self.lang_norm(lang_emb)
        vision = self.vision_norm(vision_emb)
        pos = (torch.arange(f, dtype=torch.float32, device=vision.device)
               / float(f - 1)).to(vision.dtype)[:, None]
        vision = vision + self.frame_pos_encoding(pos)[None]
        q = self.query_proj(lang).reshape(b, 1, nh, hd)
        k = self.key_proj(vision).reshape(b, f, nh, hd)
        v = self.value_proj(vision).reshape(b, f, nh, hd)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(hd))
        att = dropout(torch.softmax(att, dim=-1), self.p, self.training,
                      generator)
        ctx = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, 1, h)
        out = dropout(self.out_proj(ctx), self.p, self.training, generator)
        return out[:, 0]


# ---------------------------------------------------------------------------
# base (non-window) chapter head + two-stream
# ---------------------------------------------------------------------------


class ChapterHead(nn.Module):
    """Bias-free projections of the pooled text vector and of each frame
    vector to hidden_size, ReLU, concat [frames..., text], then a linear
    classifier over the flattened tokens (head_type "mlp") or the
    self-attention head over the tokens ("attn", 4 heads)."""

    def __init__(self, segment_size: int, hidden_size: int,
                 output_size: int = 2, head_type: str = "mlp",
                 lang_dim: int = 768, vision_dim: int = 2048,
                 p: float = 0.1):
        super().__init__()
        if head_type not in ("mlp", "attn"):
            raise ValueError(f"unknown head_type {head_type}")
        self.lang_proj_head = nn.Linear(lang_dim, hidden_size, bias=False)
        self.vision_proj_head = nn.Linear(vision_dim, hidden_size, bias=False)
        self.head = (nn.Linear((segment_size + 1) * hidden_size, output_size)
                     if head_type == "mlp" else
                     SelfAttentionHead(hidden_size, 4, output_size, p))

    def forward(self, lang_emb: torch.Tensor, vision_emb: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        lang = torch.relu(self.lang_proj_head(lang_emb))[:, None]
        vision = torch.relu(self.vision_proj_head(vision_emb))
        fusion = torch.cat([vision, lang], dim=1)  # [B, T + 1, H]
        if isinstance(self.head, nn.Linear):
            return self.head(fusion.reshape(fusion.shape[0], -1))
        return self.head(fusion, generator)


def _autocast(dtype: torch.dtype, device: torch.device):
    """bf16/fp16 autocast for a training forward on the card (the
    parameters stay float32); nothing elsewhere."""
    half = dtype in (torch.bfloat16, torch.float16)
    return (torch.autocast(device.type, dtype=dtype)
            if half and device.type == "cuda" else contextlib.nullcontext())


class TwoStream(nn.Module):
    """BERT pooled text + ResNet-TSM frames -> ChapterHead logits.

    forward(img_clips [B, T, ...], text_ids [B, L], attention_mask [B, L])
    -> (logits [B, 2], probs [B, 2])."""

    def __init__(self, lang_model: BertModel, vision_model: ResNet,
                 segment_size: int = 16, hidden_size: int = 128,
                 head_type: str = "mlp",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1):
        super().__init__()
        self.lang_model = lang_model
        self.vision_model = vision_model
        self.segment_size = segment_size
        self.dtype = dtype
        self.fusion_head = ChapterHead(
            segment_size, hidden_size, 2, head_type,
            lang_dim=lang_model.cfg.hidden_size,
            vision_dim=vision_model.feature_dim, p=dropout)

    def to_serving(self, device) -> "TwoStream":
        """Move to device; text model and head take the compute dtype.
        The vision trunk keeps float32 parameters: it folds BatchNorm in
        float32 and casts the folded weights to its own dtype."""
        self.to(device)
        self.lang_model.to(self.dtype)
        self.fusion_head.to(self.dtype)
        return self.eval()

    def head_probs(self, pooled: torch.Tensor,
                   vision: torch.Tensor) -> torch.Tensor:
        dt = self.fusion_head.lang_proj_head.weight.dtype
        logits = self.fusion_head(pooled.to(dt), vision.to(dt))
        return logits, torch.softmax(logits.float(), dim=-1)

    def forward_train(self, img_clips, text_ids, attention_mask,
                      generator: Optional[torch.Generator] = None):
        """Training forward (the JAX package's TwoStream with train=True,
        deterministic=False): BERT and head dropout from `generator`,
        batch-stat BatchNorm in the vision trunk (running averages
        updated), then the head. Parameters stay float32; on the card with
        a bf16 model dtype the text model and head run under bf16 autocast
        and the trunk casts its own weights. -> (logits [B, 2], probs
        [B, 2]), differentiable."""
        b, t = img_clips.shape[0], img_clips.shape[1]
        with _autocast(self.dtype, text_ids.device):
            _, pooled = self.lang_model(text_ids, attention_mask,
                                        generator=generator)
            vision = self.vision_model(
                img_clips.reshape(b * t, *img_clips.shape[2:])
            ).reshape(b, t, -1)
            logits = self.fusion_head(pooled, vision, generator)
        return logits, torch.softmax(logits.float(), dim=-1)

    def forward(self, img_clips, text_ids, attention_mask, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """train=True: forward_train (the JAX package's train=True,
        deterministic=False); else serving, without gradients."""
        if train:
            return self.forward_train(img_clips, text_ids, attention_mask,
                                      generator)
        with torch.no_grad():
            return self._serve(img_clips, text_ids, attention_mask)

    def _serve(self, img_clips, text_ids, attention_mask):
        b, t = img_clips.shape[0], img_clips.shape[1]
        _, pooled = self.lang_model(text_ids, attention_mask)
        vision = self.vision_model(
            img_clips.reshape(b * t, *img_clips.shape[2:])).reshape(b, t, -1)
        return self.head_probs(pooled, vision)


# ---------------------------------------------------------------------------
# window model (JAX models/fusion.py:269-518)
# ---------------------------------------------------------------------------

WINDOW_HEAD_TYPES = ("mlp", "bilinear", "multiplication", "self_attn",
                     "cross_attn")


class WindowChapterHead(nn.Module):
    """Per-window-position projection MLPs and one of five fusion types:
    lang [B, W, lang_dim] and vision [B, W, seg, vision_dim] -> fusion
    [B, W, hidden] (two_stream_window.py:134-289)."""

    def __init__(self, num_clips: int, segment_size: int, hidden_size: int,
                 head_type: str = "mlp", lang_dim: int = 768,
                 vision_dim: int = 2048, p: float = 0.1):
        super().__init__()
        if head_type not in WINDOW_HEAD_TYPES:
            raise ValueError(f"unknown head_type {head_type}")
        w, seg, h = num_clips, segment_size, hidden_size
        self.head_type, self.seg, self.h, self.p = head_type, seg, h, p
        self.lang_proj_heads = StackedMLP(w, lang_dim, (lang_dim // 2, h), p)
        self.vision_proj_heads = StackedMLP(w, vision_dim,
                                            (8 * h, 4 * h, h), p)
        if head_type == "mlp":
            self.head = StackedMLP(w, (seg + 1) * h, (8 * h, 4 * h, h), p)
        elif head_type == "bilinear":
            self.bilinear_kernel = nn.Parameter(
                torch.empty(w, 2 * h, h, seg * h))
            self.bilinear_bias = nn.Parameter(torch.zeros(w, 2 * h))
            self.head_ln_in = StackedLayerNorm(w, 2 * h)
            self.head = StackedMLP(w, 2 * h, (h, h), p)
        elif head_type == "multiplication":
            self.lang_expand_layers = StackedMLP(w, h, (8 * h, seg * h), p)
            self.lang_expand_ln = StackedLayerNorm(w, seg * h)
            self.head = StackedMLP(w, seg * h, (8 * h, 4 * h, h), p)
        elif head_type == "self_attn":
            self.head = SelfAttentionHead(h, 4, h, p)
        else:
            self.head = CrossAttentionHead(h, 16, p)

    def forward(self, lang_emb, vision_emb, generator=None):
        b, w, _ = lang_emb.shape
        h, seg, on = self.h, self.seg, self.training
        lang = torch.relu(self.lang_proj_heads(lang_emb, generator))
        # fold the segment into the batch for the per-position MLPs
        ve = vision_emb.transpose(1, 2).reshape(b * seg, w, -1)
        vision = torch.relu(self.vision_proj_heads(ve, generator))
        vision = vision.reshape(b, seg, w, h).transpose(1, 2)  # [B,W,seg,H]

        if self.head_type == "mlp":
            fused = torch.cat([vision, lang[:, :, None]], dim=2)
            return self.head(fused.reshape(b, w, (seg + 1) * h), generator)
        if self.head_type == "bilinear":
            fused = (torch.einsum("bwi,woij,bwj->bwo", lang,
                                  self.bilinear_kernel.to(lang.dtype),
                                  vision.reshape(b, w, seg * h))
                     + self.bilinear_bias.to(lang.dtype)[None])
            fused = torch.relu(self.head_ln_in(fused))
            return self.head(dropout(fused, self.p, on, generator), generator)
        if self.head_type == "multiplication":
            expanded = torch.relu(self.lang_expand_ln(
                self.lang_expand_layers(lang, generator)))
            expanded = dropout(expanded, self.p, on, generator)
            mul = vision * expanded.reshape(b, w, seg, h)
            return self.head(mul.reshape(b, w, seg * h), generator)
        if self.head_type == "self_attn":
            fused = torch.cat([vision, lang[:, :, None]], dim=2)
            return self.head(fused.reshape(b * w, seg + 1, h),
                             generator).reshape(b, w, h)
        return self.head(lang.reshape(b * w, h),
                         vision.reshape(b * w, seg, h),
                         generator).reshape(b, w, h)


class WindowAttentionBlock(nn.Module):
    """Pre-norm transformer block over the window of clips, with a learned
    scalar relative-position encoding (made in the compute type, JAX
    :396) and a per-head window bias (stacked_window_self_attention.py:
    8-148)."""

    def __init__(self, hidden_size: int, num_heads: int, window_size: int,
                 p: float = 0.1):
        super().__init__()
        h = hidden_size
        self.num_heads, self.p = num_heads, p
        self.attention_norm = nn.LayerNorm(h, eps=LN_EPS)
        self.position_encoding = nn.Linear(1, h)
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.window_pos_bias = nn.Parameter(
            torch.zeros(1, num_heads, 1, 2 * window_size + 1))
        self.out_proj = nn.Linear(h, h)
        self.ffn_norm = nn.LayerNorm(h, eps=LN_EPS)
        for i, (a, o) in enumerate(((h, 2 * h), (2 * h, 4 * h),
                                    (4 * h, 2 * h), (2 * h, h))):
            self.add_module(f"ffn{i}", nn.Linear(a, o))

    def forward(self, x, generator=None):
        b, s, h = x.shape
        nh, on = self.num_heads, self.training
        hd = h // nh
        y = self.attention_norm(x)
        middle = s // 2
        rel = ((torch.arange(s, dtype=y.dtype, device=y.device) - middle)
               / (middle + 1e-6))[:, None]
        y = y + self.position_encoding(rel)[None]
        q, k, v = (m(y).reshape(b, s, nh, hd)
                   for m in (self.query, self.key, self.value))
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        att = att + self.window_pos_bias.to(att.dtype)[..., :s]
        att = dropout(torch.softmax(att, dim=-1), self.p, on, generator)
        ctx = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, s, h)
        x = x + self.out_proj(ctx)
        y = self.ffn_norm(x)
        for i in range(4):
            y = getattr(self, f"ffn{i}")(y)
            if i < 3:
                y = F.gelu(y)
            y = dropout(y, self.p, on, generator)
        return x + y


class StackedWindowAttention(nn.Module):
    """num_layers window-attention blocks, a final LayerNorm and a deep
    classifier on the middle (target) clip
    (stacked_window_self_attention.py:150-223) -> (logits, probs)."""

    def __init__(self, hidden_size: int, num_heads: int = 16,
                 window_size: int = 1, num_layers: int = 6, p: float = 0.1):
        super().__init__()
        h = hidden_size
        self.num_layers, self.p = num_layers, p
        for i in range(num_layers):
            self.add_module(f"block{i}", WindowAttentionBlock(
                h, num_heads, window_size, p))
        self.final_layer_norm = nn.LayerNorm(h, eps=LN_EPS)
        dims = (h, h, h, h // 2, h // 4)
        for i in range(4):
            self.add_module(f"cls{i}", nn.Linear(dims[i], dims[i + 1]))
            self.add_module(f"cls_ln{i}", nn.LayerNorm(dims[i + 1],
                                                       eps=LN_EPS))
        self.classifier = nn.Linear(h // 4, 2)

    def forward(self, fusion_emb, generator=None):
        x = fusion_emb
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x, generator)
        x = self.final_layer_norm(x)
        y = x[:, x.shape[1] // 2]
        for i in range(4):
            y = getattr(self, f"cls_ln{i}")(getattr(self, f"cls{i}")(y))
            y = F.gelu(y)
            y = dropout(y, self.p, self.training, generator)
        logits = self.classifier(y)
        return logits, torch.softmax(logits.float(), dim=-1)


class WindowModel(nn.Module):
    """The shell of the window models: the window folds into the batch for
    one BERT call and, with time, for one ResNet call; a subclass sets
    fusion_head (and any further head modules) and defines head(lang
    [B, W, D], vision [B, W, T, D'], generator) -> (logits, probs).

    forward(img_clips [B, W, T, ...], text_ids [B, W, L], attention_mask
    [B, W, L]) -> (logits [B, 2], probs [B, 2]); W = 2 window_size + 1.
    eval() serves without gradients, the trunk on its inference kernels;
    train() (forward(..., train=True)) runs dropout from the generator
    and the trunk with batch-statistics BatchNorm on its training
    kernels."""

    def __init__(self, lang_model: BertModel, vision_model: ResNet,
                 window_size: int, segment_size: int, dtype: torch.dtype):
        super().__init__()
        self.lang_model = lang_model
        self.vision_model = vision_model
        self.window_size = window_size
        self.num_clips = 2 * window_size + 1
        self.segment_size = segment_size
        self.dtype = dtype

    def head(self, lang, vision, generator=None):
        raise NotImplementedError

    def to_serving(self, device) -> "WindowModel":
        """Move to device; text model and heads take the compute dtype
        (the vision trunk keeps float32 parameters, as in TwoStream)."""
        self.to(device)
        for m in self.children():
            if m is not self.vision_model:
                m.to(self.dtype)
        return self.eval()

    def _streams(self, img_clips, text_ids, attention_mask, vision_model,
                 generator=None):
        b, w, t = img_clips.shape[:3]
        if w != self.num_clips:
            raise ValueError(f"{w} clips a window, not {self.num_clips}")
        _, lang = self.lang_model(text_ids.reshape(b * w, -1),
                                  attention_mask.reshape(b * w, -1),
                                  generator=generator)
        vision = vision_model(img_clips.reshape(b * w * t,
                                                *img_clips.shape[3:]))
        return lang.reshape(b, w, -1), vision.reshape(b, w, t, -1)

    def forward_train(self, img_clips, text_ids, attention_mask,
                      generator: Optional[torch.Generator] = None):
        """Training forward (JAX train=True, deterministic=False), as
        TwoStream.forward_train -> (logits [B, 2], probs [B, 2])."""
        with _autocast(self.dtype, text_ids.device):
            lang, vision = self._streams(img_clips, text_ids, attention_mask,
                                         self.vision_model, generator)
            return self.head(lang, vision, generator)

    def serve(self, img_clips, text_ids, attention_mask,
              vision_model: Optional[ResNet] = None):
        """Inference without gradients; vision_model replaces the trunk
        (its W8A8 twin) -> (logits, probs float32)."""
        with torch.no_grad():
            lang, vision = self._streams(img_clips, text_ids, attention_mask,
                                         vision_model or self.vision_model)
            dt = next(self.fusion_head.parameters()).dtype
            return self.head(lang.to(dt), vision.to(dt))

    def forward(self, img_clips, text_ids, attention_mask, train: bool = False,
                generator: Optional[torch.Generator] = None):
        if train:
            return self.forward_train(img_clips, text_ids, attention_mask,
                                      generator)
        return self.serve(img_clips, text_ids, attention_mask)


class TwoStreamWindow(WindowModel):
    """The flagship window model (two_stream_window.py:292-445):
    WindowChapterHead's fused clip vectors through StackedWindowAttention
    (WindowModel has the batching)."""

    def __init__(self, lang_model: BertModel, vision_model: ResNet,
                 window_size: int = 1, segment_size: int = 16,
                 hidden_size: int = 128, head_type: str = "mlp",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1):
        super().__init__(lang_model, vision_model, window_size, segment_size,
                         dtype)
        self.fusion_head = WindowChapterHead(
            self.num_clips, segment_size, hidden_size, head_type,
            lang_dim=lang_model.cfg.hidden_size,
            vision_dim=vision_model.feature_dim, p=dropout)
        self.window_attn = StackedWindowAttention(
            hidden_size, num_heads=16, window_size=window_size, p=dropout)

    def head(self, lang, vision, generator=None):
        return self.window_attn(self.fusion_head(lang, vision, generator),
                                generator)
