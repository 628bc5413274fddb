"""Loss functions (counterpart of the JAX package's train/objectives.py;
only the clip classification loss is ported so far)."""

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
