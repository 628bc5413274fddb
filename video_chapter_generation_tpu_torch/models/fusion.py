"""Two-stream clip classifier: the mlp ChapterHead and TwoStream
(counterpart of the JAX package's models/fusion.py:192-261). Names follow
the reference's two_stream.py, which the JAX package's
`convert_base_chapter_head` reads."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from .bert import BertModel
from .resnet import ResNet


class ChapterHead(nn.Module):
    """Bias-free projections of the pooled text vector and of each frame
    vector to hidden_size, ReLU, concat [frames..., text], then a linear
    classifier over the flattened tokens (head_type "mlp")."""

    def __init__(self, segment_size: int, hidden_size: int,
                 output_size: int = 2, head_type: str = "mlp",
                 lang_dim: int = 768, vision_dim: int = 2048):
        super().__init__()
        if head_type != "mlp":
            raise NotImplementedError(f"head_type {head_type!r} is not ported")
        self.lang_proj_head = nn.Linear(lang_dim, hidden_size, bias=False)
        self.vision_proj_head = nn.Linear(vision_dim, hidden_size, bias=False)
        self.head = nn.Linear((segment_size + 1) * hidden_size, output_size)

    def forward(self, lang_emb: torch.Tensor,
                vision_emb: torch.Tensor) -> torch.Tensor:
        lang = torch.relu(self.lang_proj_head(lang_emb))[:, None]
        vision = torch.relu(self.vision_proj_head(vision_emb))
        fusion = torch.cat([vision, lang], dim=1)  # [B, T + 1, H]
        return self.head(fusion.reshape(fusion.shape[0], -1))


class TwoStream(nn.Module):
    """BERT pooled text + ResNet-TSM frames -> ChapterHead logits.

    forward(img_clips [B, T, ...], text_ids [B, L], attention_mask [B, L])
    -> (logits [B, 2], probs [B, 2])."""

    def __init__(self, lang_model: BertModel, vision_model: ResNet,
                 segment_size: int = 16, hidden_size: int = 128,
                 head_type: str = "mlp",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lang_model = lang_model
        self.vision_model = vision_model
        self.segment_size = segment_size
        self.dtype = dtype
        self.fusion_head = ChapterHead(
            segment_size, hidden_size, 2, head_type,
            lang_dim=lang_model.cfg.hidden_size,
            vision_dim=vision_model.feature_dim)

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
        dt = self.fusion_head.head.weight.dtype
        logits = self.fusion_head(pooled.to(dt), vision.to(dt))
        return logits, torch.softmax(logits.float(), dim=-1)

    def forward_train(self, img_clips, text_ids, attention_mask,
                      generator: Optional[torch.Generator] = None):
        """Training forward (the JAX package's TwoStream with train=True,
        deterministic=False): BERT dropout from `generator`, batch-stat
        BatchNorm in the vision trunk (running averages updated), then
        the head. Parameters stay float32; on the card with a bf16 model
        dtype the text model and head run under bf16 autocast and the
        trunk casts its own weights. -> (logits [B, 2], probs [B, 2]),
        differentiable."""
        b, t = img_clips.shape[0], img_clips.shape[1]
        dev = text_ids.device
        half = self.dtype in (torch.bfloat16, torch.float16)
        ctx = (torch.autocast(dev.type, dtype=self.dtype)
               if half and dev.type == "cuda" else contextlib.nullcontext())
        with ctx:
            _, pooled = self.lang_model(text_ids, attention_mask,
                                        generator=generator)
            vision = self.vision_model(
                img_clips.reshape(b * t, *img_clips.shape[2:])
            ).reshape(b, t, -1)
            logits = self.fusion_head(pooled, vision)
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
