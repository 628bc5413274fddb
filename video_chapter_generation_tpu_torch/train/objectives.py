"""Loss functions (counterpart of the JAX package's train/objectives.py):
the clip classification loss, the masked-token loss of subtitle
pretraining, the title loss, and the MoCo InfoNCE and ListNet losses of
the contrastive and listwise text training."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def info_nce_loss(q: torch.Tensor, k_pos: torch.Tensor, queue: torch.Tensor,
                  temperature: float = 0.07
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MoCo InfoNCE (train/objectives.py:68): q [B, D] against its positive
    keys k_pos [B, D] and a negatives queue [K, D], all L2-normalized;
    the positive is logit 0. The logits and their log-softmax are in at
    least float32."""
    q, k_pos, queue = (at_least_f32(t) for t in (q, k_pos, queue))
    l_pos = (q * k_pos).sum(-1, keepdim=True)
    logits = torch.cat([l_pos, q @ queue.t()], dim=1) / temperature
    labels = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == 0).to(logits.dtype).mean()
    return loss, {"loss": loss, "acc": acc}


def listnet_loss(scores: torch.Tensor, relevance: torch.Tensor,
                 aux_logits: Optional[torch.Tensor] = None,
                 aux_labels: Optional[torch.Tensor] = None,
                 aux_weight: float = 1.0
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """ListNet top-1 cross entropy between the softmax of the scores and
    that of the relevance over the slate axis, plus, given aux_logits, an
    auxiliary binary cross entropy (train/objectives.py:80). scores,
    relevance [B, slate]. In at least float32."""
    p_pred = F.log_softmax(at_least_f32(scores), dim=-1)
    p_true = torch.softmax(at_least_f32(relevance), dim=-1)
    loss = -(p_true * p_pred).sum(-1).mean()
    metrics = {"listnet_loss": loss}
    if aux_logits is not None:
        aux, am = clip_classification_loss(
            aux_logits.reshape(-1, aux_logits.shape[-1]),
            aux_labels.reshape(-1))
        loss = loss + aux_weight * aux
        metrics["aux_loss"] = aux
        metrics["acc"] = am["acc"]
    metrics["loss"] = loss
    return loss, metrics
