"""MoCo contrastive text pretraining and ListNet listwise ranking over a
BERT encoder (counterpart of the JAX package's models/contrastive.py).

- MoCoTextEncoder (JAX :37-116): a query BERT, a momentum key BERT that
  takes no gradient, and the negatives queue [K, D] with its pointer.
  The JAX package keeps them in a MoCoState pytree it returns anew each
  step; here they are the module's state, changed in place: the key
  encoder's parameters by `momentum_update`, the queue and pointer (two
  buffers) by `dequeue_and_enqueue`.
- ListwiseBert (JAX :119-167): slate-wise scoring where the positive
  clip's pooled vector (slot 0) is dotted against the contrast slots,
  the ListNet loss on the relevance of those slots plus a binary head's
  cross entropy over the slate rows.

Both encoders run BERT without dropout, as the JAX package's do (its
BertModel defaults to deterministic=True and `encode` and
`train_forward` pass nothing): the configuration's dropout rates are
set to 0. `dtype` is the compute dtype: bf16 runs BERT under autocast on
the card with float32 weights (the JAX CLIs build their BERT in float32
whatever the config says); the normalisation, the logits and every loss
are in at least float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.tsm_block_train import at_least_f32
from . import convert
from .bert import BertConfig, BertModel
from .fusion import _autocast


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / sqrt(sum(x^2) + eps) (JAX :26): eps inside the root, unlike
    F.normalize's clamp of the norm."""
    return x / torch.sqrt((x * x).sum(dim, keepdim=True) + eps)


def _deterministic(cfg: BertConfig) -> BertConfig:
    return dataclasses.replace(cfg, hidden_dropout=0.0, attention_dropout=0.0)


class MoCoTextEncoder(nn.Module):
    """Query and key BERT encoders, the queue and its pointer.

    A training step, in the order of the JAX step (models/contrastive.py
    :87-107, cli/pretrain_contrastive.py:62-82):

        logits, labels, keys = enc(query_ids, query_mask, cand_ids,
                                   cand_mask)   # steps 1-4
        loss = cross_entropy(logits, labels); loss.backward()
        clip and step the optimizer of encoder_q  # step 5
        enc.dequeue_and_enqueue(keys)             # step 6

    `forward` momentum-updates the key encoder from the query parameters
    as they are before the optimizer step, picks the positive candidate
    with the query encoder, encodes it with the key encoder and builds
    [l_pos, l_neg] / T against the queue as it is before this step. The
    queue is enqueued after the backward: the logits' graph holds it."""

    def __init__(self, cfg: BertConfig, K: int = 65536, m: float = 0.999,
                 T: float = 0.07, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg = _deterministic(cfg)
        self.K, self.m, self.T, self.dtype = K, m, T, dtype
        self.encoder_q = BertModel(cfg)
        self.encoder_k = BertModel(cfg)
        self.encoder_k.requires_grad_(False)
        self.register_buffer("queue", torch.zeros(K, cfg.hidden_size))
        self.register_buffer("queue_ptr", torch.zeros((), dtype=torch.long))

    def init_state(self, seed: int) -> Dict[str, torch.Tensor]:
        """Seeded random weights in the JAX layout, the key encoder a copy
        of the query encoder and a queue of normalized normal rows (the
        JAX init_state, :47-59, from numpy's generator: the port cannot
        draw jax.random's numbers)."""
        entries = convert.bert_entries(self.cfg.num_layers)
        tree = convert.random_jax_tree(self.encoder_q, entries, seed=seed)
        bert = convert.from_jax(tree, entries)
        queue = np.random.default_rng(seed + 1).standard_normal(
            (self.K, self.cfg.hidden_size))
        sd = {f"encoder_{s}.{k}": v.clone() for s in "qk"
              for k, v in bert.items()}
        sd["queue"] = l2_normalize(torch.from_numpy(queue)).float()
        sd["queue_ptr"] = torch.zeros((), dtype=torch.long)
        return sd

    def encode(self, encoder: BertModel, ids: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
        """L2-normalized pooled output [B, D], in at least float32."""
        with _autocast(self.dtype, ids.device):
            _, pooled = encoder(ids.long(), mask)
        return l2_normalize(at_least_f32(pooled))

    @torch.no_grad()
    def momentum_update(self) -> None:
        """k <- k m + q (1 - m), parameter by parameter (JAX :65-70)."""
        for pk, pq in zip(self.encoder_k.parameters(),
                          self.encoder_q.parameters()):
            pk.copy_(pk * self.m + pq * (1.0 - self.m))

    @torch.no_grad()
    def select_positive(self, q_emb, cand_ids, cand_mask
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per query, the candidate of most query-encoder similarity, the
        first on a tie (bert_hugface_constrast.py:120-137; JAX :72-85)."""
        b, c, length = cand_ids.shape
        cand_emb = self.encode(self.encoder_q, cand_ids.reshape(b * c, length),
                               cand_mask.reshape(b * c, length)
                               ).reshape(b, c, -1)
        sims = torch.einsum("bcd,bd->bc", cand_emb, q_emb)
        best = sims.argmax(dim=1)  # torch takes the first maximum
        rows = torch.arange(b, device=cand_ids.device)
        return cand_ids[rows, best], cand_mask[rows, best]

    def forward(self, query_ids, query_mask, cand_ids, cand_mask
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Steps 1-4 of a MoCo step -> (logits [B, 1 + K], labels [B] (all
        0), keys [B, D] to enqueue after the backward)."""
        q = self.encode(self.encoder_q, query_ids, query_mask)
        self.momentum_update()
        sel_ids, sel_mask = self.select_positive(q.detach(), cand_ids,
                                                 cand_mask)
        with torch.no_grad():
            k = self.encode(self.encoder_k, sel_ids, sel_mask)
        l_pos = (q * k).sum(-1, keepdim=True)
        l_neg = q @ self.queue.to(q.dtype).t()
        logits = torch.cat([l_pos, l_neg], dim=1) / self.T
        labels = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
        return logits, labels, k

    @torch.no_grad()
    def dequeue_and_enqueue(self, keys: torch.Tensor) -> None:
        """keys into the queue at queue_ptr, which moves on by B modulo K
        (JAX :109-116); K must be a multiple of B."""
        b = keys.shape[0]
        assert self.K % b == 0, "queue size must be divisible by batch"
        rows = self.queue_ptr + torch.arange(b, device=keys.device)
        self.queue.index_copy_(0, rows, keys.to(self.queue.dtype))
        self.queue_ptr.copy_((self.queue_ptr + b) % self.K)


class ListwiseBert(nn.Module):
    """Slate-wise ListNet scorer over a BERT encoder with a binary head
    (nn.Dense(2) of the JAX package; names bert.* and head.*)."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg = _deterministic(cfg)
        self.dtype = dtype
        self.bert = BertModel(cfg)
        self.head = nn.Linear(cfg.hidden_size, 2)

    def init_state(self, seed: int) -> Dict[str, torch.Tensor]:
        """Seeded random weights in the JAX layout."""
        entries = convert.listwise_bert_entries(self.cfg.num_layers)
        return convert.from_jax(
            convert.random_jax_tree(self, entries, seed=seed), entries)

    def pooled(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        with _autocast(self.dtype, ids.device):
            _, pooled = self.bert(ids.long(), mask)
        return at_least_f32(pooled)

    def train_forward(self, ids, mask, targets, balance_idx, binary_labels
                      ) -> Dict[str, torch.Tensor]:
        """ids and mask [B, slate, L]; targets [B, slate] relevance, slot 0
        the positive clip (bert_hugface_listnet.py:149-176; JAX :138-161):
        ListNet on the contrast slots' targets[:, 1:], plus the binary
        head's cross entropy over the rows balance_idx of the flattened
        slate."""
        b, s, length = ids.shape
        pooled = self.pooled(ids.reshape(b * s, length),
                             mask.reshape(b * s, length))
        emb = pooled.reshape(b, s, -1)
        scores = torch.einsum("bod,bsd->bs", emb[:, :1], emb[:, 1:])
        log_p = F.log_softmax(scores, dim=-1)
        surrogate = -(targets[:, 1:].to(log_p.dtype) * log_p).sum(-1).mean()
        binary_logits = self.head(pooled[balance_idx].to(
            self.head.weight.dtype))
        binary_loss = F.cross_entropy(at_least_f32(binary_logits),
                                      binary_labels.long())
        return {"loss": surrogate + binary_loss,
                "surrogate_loss": surrogate, "binary_loss": binary_loss,
                "binary_logits": binary_logits}

    def test_forward(self, ids: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
        """The binary head's logits [B, 2] of each text."""
        return self.head(self.pooled(ids, mask).to(self.head.weight.dtype))

