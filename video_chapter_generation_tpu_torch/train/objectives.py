"""Loss functions (counterpart of the JAX package's train/objectives.py):
the clip classification loss and the title loss. The masked-token,
InfoNCE and ListNet losses go with the models that need them (ROADMAP
queue 1 item 12)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.tsm_block_train import at_least_f32


def clip_classification_loss(logits: torch.Tensor, labels: torch.Tensor
                             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits [B, 2], labels [B] int -> mean cross entropy + accuracy
    (train/objectives.py:28). The reduction runs in at least float32."""
    logits = at_least_f32(logits)
    labels = labels.long()
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).to(logits.dtype).mean()
    return loss, {"loss": loss, "acc": acc}


def seq2seq_title_loss(logits: torch.Tensor, target_ids: torch.Tensor,
                       decode_attention_mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits [B, L, V], target_ids and decode_attention_mask [B, L] ->
    cross entropy and token accuracy over the real decoder positions
    (train/objectives.py:55-66). The reduction runs in at least
    float32."""
    logits = at_least_f32(logits)
    targets = target_ids.long()
    mask = decode_attention_mask.to(logits.dtype)
    ce = F.cross_entropy(logits.flatten(0, 1), targets.flatten(),
                         reduction="none").reshape(targets.shape)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (ce * mask).sum() / denom
    correct = (logits.argmax(-1) == targets).to(logits.dtype)
    acc = (correct * mask).sum() / denom
    return loss, {"loss": loss, "acc": acc}
