"""The from-scratch decoder-only GPT (counterpart of the JAX package's
models/gpt.py:1-223): causal self-attention blocks, pre-norm (minGPT) or
post-norm (openai-gpt), learnable or fixed interleaved-sinusoidal
positions, token ids or external (GloVe) embeddings as input, a bias-free
vocabulary head, the masked next-token loss and sampling.

Module names follow the JAX tree (block{i}/{ln1, ln2, attn/{query, key,
value, proj}, mlp_fc, mlp_proj}, ln_f, head) under `blocks.{i}`, so
models/convert.py:gpt_entries carries weights across. LayerNorm takes
flax's epsilon (1e-6), the MLP the exact GELU, and the attention scores
go through softmax in at least float32, as the port's other attention
does. In train() mode the three dropouts are active, drawn from the
torch.Generator the caller passes. GPT runs no Pallas kernel in the JAX
package, and no hand-written kernel here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..train.objectives import masked_token_loss
from .bert import dropout
from .seq2seq import top_k_filter

LN_EPS = 1e-6  # flax nn.LayerNorm's default


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 10000
    block_size: int = 128
    n_layer: int = 3
    n_head: int = 8
    n_embd: int = 256
    embd_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    resid_pdrop: float = 0.1
    learnable_pos_emb: bool = False  # the reference: sinusoidal, frozen
    using_pretrained_embed: bool = False  # True: inputs are embeddings
    pre_norm: bool = True  # minGPT: pre-norm; openai-gpt: post-norm

    @classmethod
    def openai_gpt(cls) -> "GPTConfig":
        return cls(vocab_size=40478, block_size=512, n_layer=12, n_head=12,
                   n_embd=768, learnable_pos_emb=True, pre_norm=False)


def interleaved_sinusoidal(length: int, d_model: int) -> np.ndarray:
    """pe[:, 0::2] = sin, pe[:, 1::2] = cos, float32 [length, d_model]
    (JAX gpt.py:43-53; interleaved, unlike Pegasus's half split)."""
    if d_model % 2 != 0:
        raise ValueError("odd d_model")
    pe = np.zeros((length, d_model), np.float32)
    position = np.arange(length)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d_model, 2) * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        c = cfg.n_embd
        self.cfg = cfg
        self.query = nn.Linear(c, c)
        self.key = nn.Linear(c, c)
        self.value = nn.Linear(c, c)
        self.proj = nn.Linear(c, c)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        b, t, c = x.shape
        def split(y):
            return y.reshape(b, t, cfg.n_head, -1).transpose(1, 2)

        q, k, v = (split(self.query(x)), split(self.key(x)),
                   split(self.value(x)))
        att = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        if att.dtype != torch.float64:  # softmax in at least float32
            att = att.float()
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        att = torch.where(causal, att, torch.full_like(att, -1e9))
        att = torch.softmax(att, dim=-1).to(v.dtype)
        att = dropout(att, cfg.attn_pdrop, self.training, generator)
        y = (att @ v).transpose(1, 2).reshape(b, t, c)
        return dropout(self.proj(y), cfg.resid_pdrop, self.training,
                       generator)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.ln1 = nn.LayerNorm(cfg.n_embd, eps=LN_EPS)
        self.ln2 = nn.LayerNorm(cfg.n_embd, eps=LN_EPS)
        self.attn = CausalSelfAttention(cfg)
        self.mlp_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd)
        self.mlp_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd)

    def mlp(self, y, generator):
        y = self.mlp_proj(F.gelu(self.mlp_fc(y), approximate="none"))
        return dropout(y, self.cfg.resid_pdrop, self.training, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.cfg.pre_norm:
            x = x + self.attn(self.ln1(x), generator)
            return x + self.mlp(self.ln2(x), generator)
        x = self.ln1(x + self.attn(x, generator))
        return self.ln2(x + self.mlp(x, generator))


class GPT(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        if not cfg.using_pretrained_embed:
            self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.n_embd)
        if cfg.learnable_pos_emb:
            self.pos_emb = nn.Parameter(
                torch.zeros(1, cfg.block_size, cfg.n_embd))
        else:
            # fixed: float32, not a buffer (a model built on the meta
            # device keeps it), moved to the input's device on use
            self._sin_pos = torch.from_numpy(
                interleaved_sinusoidal(cfg.block_size, cfg.n_embd))[None]
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=LN_EPS)
        self.head = nn.Linear(cfg.n_embd, cfg.vocab_size, bias=False)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: token ids [B, T], or embeddings [B, T, D] with
        using_pretrained_embed -> logits [B, T, V]."""
        cfg = self.cfg
        if cfg.using_pretrained_embed:
            tok = x.to(self.ln_f.weight.dtype)
        else:
            tok = self.tok_emb(x.long())
        t = tok.shape[1]
        if t > cfg.block_size:
            raise ValueError(f"{t} tokens exhaust the block size "
                             f"{cfg.block_size}")
        if cfg.learnable_pos_emb:
            pos = self.pos_emb
        else:
            if self._sin_pos.device != tok.device:
                self._sin_pos = self._sin_pos.to(tok.device)
            pos = self._sin_pos
        h = dropout(tok + pos[:, :t].to(tok.dtype), cfg.embd_pdrop,
                    self.training, generator)
        for blk in self.blocks:
            h = blk(h, generator)
        return self.head(self.ln_f(h))


def gpt_loss(logits: torch.Tensor, targets: torch.Tensor,
             ignore_index: int = -1):
    """Masked next-token cross entropy over targets != ignore_index (JAX
    gpt.py:140-144) -> (loss, {"loss", "acc"})."""
    return masked_token_loss(logits, targets, ignore_index)


def _pick(scaled: torch.Tensor, top_k: Optional[int], sample: bool,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    if top_k is not None:
        scaled = top_k_filter(scaled, top_k)
    if sample:
        probs = torch.softmax(scaled.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return scaled.argmax(dim=-1)


def sample_next(logits: torch.Tensor, temperature: float = 1.0,
                top_k: Optional[int] = None, sample: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One sampling step from the last position's logits [B, T, V] -> ids
    [B] (JAX gpt.py:147-158): divided by temperature, top-k filtered,
    then drawn from `generator` (sample) or the argmax."""
    return _pick(logits[:, -1, :] / temperature, top_k, sample, generator)


@torch.no_grad()
def gpt_generate(model: GPT, prompt_ids: torch.Tensor,
                 prompt_len: Optional[torch.Tensor] = None,
                 max_new_tokens: int = 30, temperature: float = 1.0,
                 top_k: Optional[int] = None, sample: bool = False,
                 generator: Optional[torch.Generator] = None,
                 eos_token_id: Optional[int] = None) -> torch.Tensor:
    """Autoregressive generation (JAX gpt.py:166-223): the whole padded
    context [B, L + max_new_tokens] re-runs every step, as the JAX
    function and the reference do (no cache). prompt_ids [B, L]
    left-aligned, prompt_len [B] their real lengths (default L); step i
    reads the logits at prompt_len - 1 + i and writes its token one past
    it, per row. With eos_token_id a row that emitted it emits it from
    then on. Returns ids [B, max_new_tokens]."""
    b, l = prompt_ids.shape
    total = l + max_new_tokens
    if total > model.cfg.block_size:
        raise ValueError(f"{total} tokens exhaust the block size "
                         f"{model.cfg.block_size}")
    dev = prompt_ids.device
    if prompt_len is None:
        prompt_len = torch.full((b,), l, dtype=torch.long, device=dev)
    prompt_len = prompt_len.to(dev).long()
    buf = torch.zeros(b, total, dtype=torch.long, device=dev)
    buf[:, :l] = prompt_ids
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    out = []
    for i in range(max_new_tokens):
        pos = prompt_len - 1 + i  # the last real token of each row
        last = model(buf)[rows, pos]
        nxt = _pick(last / temperature, top_k, sample, generator)
        if eos_token_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        buf[rows, pos + 1] = nxt
        out.append(nxt)
    return torch.stack(out, dim=1)
