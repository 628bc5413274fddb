"""Loss functions (counterpart of the JAX package's train/objectives.py):
the clip classification loss, the masked-token loss of subtitle
pretraining and the title loss. The InfoNCE and ListNet losses go with
the models that need them (ROADMAP queue 1 item 12)."""

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


def masked_token_loss(logits: torch.Tensor, targets: torch.Tensor,
                      ignore_index: int = -1
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits [B, L, V], targets [B, L] -> cross entropy and accuracy over
    the positions whose target is not ignore_index (MLM and next-token
    pretraining; train/objectives.py:40). The reduction runs in at least
    float32."""
    logits = at_least_f32(logits)
    targets = targets.long()
    valid = targets != ignore_index
    safe = torch.where(valid, targets, torch.zeros_like(targets))
    ce = F.cross_entropy(logits.flatten(0, 1), safe.flatten(),
                         reduction="none").reshape(targets.shape)
    denom = torch.clamp(valid.sum(), min=1).to(logits.dtype)
    loss = torch.where(valid, ce, torch.zeros_like(ce)).sum() / denom
    hits = valid & (logits.argmax(-1) == safe)
    acc = hits.sum().to(logits.dtype) / denom
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
