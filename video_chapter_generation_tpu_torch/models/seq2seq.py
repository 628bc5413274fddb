"""Encoder-decoder title models: the teacher-forced training forward
with dropout and rematerialization, KV-cached decoding (greedy, top-k
and sampling, beam search), and the vision-conditioned variant
(counterpart of the JAX package's models/seq2seq.py:35-1033).

Three families from one config (JAX :35-120): Pegasus-large (pre-norm
with a final LayerNorm on each side, fairseq sinusoidal positions,
embeddings scaled by sqrt(d_model), relu), BigBird-Pegasus-large (the
same with learned positions, tanh gelu, bias-free attention and the
block-sparse encoder self-attention of models/sparse_attention.py, kernel
K10) and BART-large (post-norm, learned positions at offset 2, an
embedding LayerNorm, exact gelu). The LM head is tied to the shared table
plus final_logits_bias. Module names follow HuggingFace's Pegasus/BART
(`model.{encoder,decoder}.embed_positions` for learned tables,
`.layernorm_embedding` for BART's embedding LayerNorm), so the JAX
package's `convert_hf_seq2seq` reads this state dict as it is (under
Seq2SeqVisionEmb, after the `seq2seq.` prefix). Serving in int8 (JAX
:68-84):
weight_quant swaps every layer Linear for Int8Linear and the shared table
for Int8Embed (models/quant_layers.py; load a state dict made by
ops/quantize.py:quantize_seq2seq), and kv_quant keeps the cross-attention
K/V cache in int8 with scales per (batch, head, channel) that fold into q
and into the attention output exactly.

Training (JAX :44, 74-77, 416-420, 495-519): `forward` is the
teacher-forced encode and decode with the causal and padding biases. In
train() mode dropout (cfg.dropout) applies where the JAX model applies
it: after the embeddings, after each FFN activation and on every
residual branch; attention probabilities are not dropped. The masks come
from a torch.Generator: each encode or decode draws one seed a layer
from the caller's generator (one host read), and every layer draws its
masks from a generator seeded with its own seed, in the spirit of JAX's
fold_in. With cfg.remat each layer runs under torch.utils.checkpoint,
and its recomputation re-seeds the same generator, so the masks and the
gradients are those of the run without remat.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .bert import dropout
from .quant_layers import Int8Embed, Int8Linear
from .sparse_attention import SPARSE_IMPLS, block_sparse_attention

NEG_INF = -1e9
FUSION_TYPES = ("cross_attn", "mlp")  # Seq2SeqVisionEmb's fusion heads


@dataclass(frozen=True)
class Seq2SeqConfig:
    vocab_size: int = 96103
    d_model: int = 1024
    encoder_layers: int = 16
    decoder_layers: int = 16
    num_heads: int = 16
    ffn_dim: int = 4096
    max_positions: int = 1024
    activation: str = "relu"  # relu | gelu_new (tanh form) | gelu (exact)
    pre_norm: bool = True  # pegasus: True (+ final LN); bart: False
    learned_positions: bool = False
    position_offset: int = 0  # bart: 2
    scale_embedding: bool = True
    embed_layernorm: bool = False  # bart: a LayerNorm after the embeddings
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    # long context (BigBird-Pegasus): block-sparse encoder self-attention
    encoder_attention: str = "full"  # full | block_sparse
    attention_bias: bool = True  # BigBird's projections have no biases
    block_size: int = 64
    num_rand_blocks: int = 3
    num_global_blocks: int = 1
    weight_quant: bool = False
    kv_quant: bool = False
    # training (JAX :44, 64-67, 74-77): the dropout rate in train() mode,
    # one checkpointed recomputation a layer, and the block-sparse
    # encoder's route ("auto": K10 where no gradient is needed, the
    # gather formulation where one is; "gather" or "kernel" force one)
    dropout: float = 0.1
    remat: bool = False
    sparse_impl: str = "auto"

    @classmethod
    def pegasus_large(cls) -> "Seq2SeqConfig":
        return cls()

    @classmethod
    def bigbird_pegasus_large(cls) -> "Seq2SeqConfig":
        """google/bigbird-pegasus-large-arxiv's shape (JAX :91-102): 4096
        learned positions, gelu_new, bias-free attention, decoder start 2,
        block-sparse encoder with 64-token blocks and 3 random blocks."""
        return cls(
            max_positions=4096, encoder_attention="block_sparse",
            block_size=64, num_rand_blocks=3, num_global_blocks=1,
            scale_embedding=True, activation="gelu_new",
            learned_positions=True, decoder_start_token_id=2,
            attention_bias=False)

    @classmethod
    def bart_large(cls) -> "Seq2SeqConfig":
        """facebook/bart-large's shape (JAX :105-111)."""
        return cls(
            vocab_size=50265, encoder_layers=12, decoder_layers=12,
            activation="gelu", pre_norm=False, learned_positions=True,
            position_offset=2, scale_embedding=False, embed_layernorm=True,
            pad_token_id=1, eos_token_id=2, decoder_start_token_id=2)

    @classmethod
    def tiny(cls, vocab_size: int = 128, **kw) -> "Seq2SeqConfig":
        base = dict(vocab_size=vocab_size, d_model=32, encoder_layers=2,
                    decoder_layers=2, num_heads=2, ffn_dim=64,
                    max_positions=64)
        base.update(kw)
        return cls(**base)


def sinusoidal_positions(n_pos: int, dim: int) -> np.ndarray:
    """Fairseq/Pegasus layout: out[:, :dim//2] = sin(pos/1e4^(2(j//2)/d))
    at even j; out[:, dim//2:] = cos at odd j."""
    j = np.arange(dim)
    pe = np.arange(n_pos)[:, None] / np.power(10000, 2 * (j // 2) / dim)[None]
    out = np.zeros((n_pos, dim), dtype=np.float32)
    half = dim // 2
    out[:, :half] = np.sin(pe[:, 0::2])
    out[:, half:] = np.cos(pe[:, 1::2])
    return out


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, K] 1/0 -> additive float32 [B, 1, 1, K]."""
    return (1.0 - mask[:, None, None, :].float()) * NEG_INF


def _causal_bias(length: int, device) -> torch.Tensor:
    """Additive float32 [1, 1, L, L]: -1e9 above the diagonal (JAX
    seq2seq.py:382-385)."""
    i = torch.arange(length, device=device)
    return torch.where(i[None, :] <= i[:, None], 0.0, NEG_INF)[None, None]


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """bf16/fp16 -> float32; float32 and float64 as they are."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _layer_seeds(generator: Optional[torch.Generator], n: int,
                 on: bool) -> List[Optional[int]]:
    """n dropout seeds drawn from `generator` (the default generator when
    None), one host read; all None when dropout is off."""
    if not on:
        return [None] * n
    dev = generator.device if generator is not None else "cpu"
    return torch.randint(0, 2 ** 62, (n,), generator=generator,
                         device=dev).tolist()


def _seeded(seed: Optional[int], device) -> Optional[torch.Generator]:
    if seed is None:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _drop(x: torch.Tensor, p: float,
          gen: Optional[torch.Generator]) -> torch.Tensor:
    """models/bert.py's inverted dropout from `gen`; the identity without
    a generator (dropout off)."""
    return dropout(x, p, gen is not None, gen)


def _linear(cfg: Seq2SeqConfig, d_in: int, d_out: int,
            bias: bool = True) -> nn.Module:
    """nn.Linear, or its weight-only int8 form (JAX seq2seq.py:139-145)."""
    return (Int8Linear if cfg.weight_quant else nn.Linear)(d_in, d_out,
                                                           bias=bias)


def _ffn(layer: nn.Module, x: torch.Tensor,
         gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """fc2(dropout(act(fc1(x)))) (JAX seq2seq.py:232-242)."""
    return layer.fc2(_drop(layer.act(layer.fc1(x)), layer.p, gen))


def _activation(name: str):
    """The FFN activation (JAX seq2seq.py:232-242): flax's nn.gelu default
    is the tanh form, which HF calls gelu_new."""
    if name == "relu":
        return F.relu
    if name == "gelu_new":
        return lambda y: F.gelu(y, approximate="tanh")
    if name == "gelu":
        return F.gelu
    raise ValueError(f"unknown activation {name!r}")


def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """int8 cached K/V heads [B, H, K, hd] with scales per (batch, head,
    channel): the amax over the K positions (JAX seq2seq.py:361) ->
    (k_q, k_scale, v_q, v_scale), scales float32 [B, H, 1, hd]."""
    def quant(x):
        xf = x.float()
        amax = xf.abs().amax(dim=2, keepdim=True)
        scale = torch.clamp(amax, min=1e-8) / 127.0
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        return q, scale

    k_q, k_scale = quant(k)
    v_q, v_scale = quant(v)
    return k_q, k_scale, v_q, v_scale


class Attention(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        ub = cfg.attention_bias
        self.q_proj = _linear(cfg, d, d, ub)
        self.k_proj = _linear(cfg, d, d, ub)
        self.v_proj = _linear(cfg, d, d, ub)
        self.out_proj = _linear(cfg, d, d, ub)

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        """[B, L, D] -> [B, H, L, hd]."""
        b, l, _ = x.shape
        return x.reshape(b, l, self.num_heads, -1).transpose(1, 2)

    def project_kv(self, kv_in: torch.Tensor):
        return self.heads(self.k_proj(kv_in)), self.heads(self.v_proj(kv_in))

    def forward(self, q_in, bias, kv_in=None, cached_kv=None):
        """bias: additive float32, broadcastable to [B, H, Q, K];
        cached_kv: precomputed (k, v) [B, H, K, hd], or the int8 form
        (k_q, k_scale, v_q, v_scale) of quantize_kv: the key scales fold
        into q before the scores, the value scales into the attention
        output after the value product (JAX seq2seq.py:174-190)."""
        q = self.heads(self.q_proj(q_in))
        v_scale = None
        if cached_kv is None:
            k, v = self.project_kv(kv_in)
        elif len(cached_kv) == 4:
            k, k_scale, v, v_scale = cached_kv
            q = q * k_scale.to(q.dtype)
            k = k.to(q.dtype)
        else:
            k, v = cached_kv
        att = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        att = torch.softmax(_at_least_f32(att) + bias, dim=-1).to(q.dtype)
        ctx = att @ v.to(q.dtype)
        if v_scale is not None:
            ctx = ctx * v_scale.to(ctx.dtype)
        return self.out_proj(ctx.transpose(1, 2).reshape(q_in.shape))

    def sparse_self(self, x, mask, rand_map=None):
        """Block-sparse self-attention over x [B, L, D] with mask [B, L]
        (JAX seq2seq.py:203-219): q, k, v stay [B, L, H, hd], the layout
        the K10 kernel reads without a transpose."""
        cfg = self.cfg
        b, l, d = x.shape
        split = lambda t: t.reshape(b, l, self.num_heads, -1)  # noqa: E731
        ctx = block_sparse_attention(
            split(self.q_proj(x)), split(self.k_proj(x)),
            split(self.v_proj(x)), mask, cfg.block_size, cfg.num_rand_blocks,
            cfg.num_global_blocks, rand_map=rand_map, impl=cfg.sparse_impl)
        return self.out_proj(ctx.reshape(b, l, d))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.p = cfg.dropout
        self.act = _activation(cfg.activation)
        self.self_attn = Attention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = _linear(cfg, d, cfg.ffn_dim)
        self.fc2 = _linear(cfg, cfg.ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x, bias, mask=None, rand_map=None,
                seed: Optional[int] = None):
        """Pre- or post-norm (JAX seq2seq.py:256-278); the block-sparse
        encoder attends with the [B, L] mask, the full one with bias.
        seed: this layer's dropout seed (None: no dropout)."""
        gen = _seeded(seed, x.device)

        def attend(y):
            if self.cfg.encoder_attention == "block_sparse":
                return self.self_attn.sparse_self(y, mask, rand_map)
            return self.self_attn(y, bias, kv_in=y)

        ln1, ln2 = self.self_attn_layer_norm, self.final_layer_norm
        if self.cfg.pre_norm:
            x = x + _drop(attend(ln1(x)), self.p, gen)
            return x + _drop(_ffn(self, ln2(x), gen), self.p, gen)
        x = ln1(x + _drop(attend(x), self.p, gen))
        return ln2(x + _drop(_ffn(self, x, gen), self.p, gen))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        d = cfg.d_model
        self.pre_norm = cfg.pre_norm
        self.p = cfg.dropout
        self.act = _activation(cfg.activation)
        self.self_attn = Attention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.encoder_attn = Attention(cfg)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = _linear(cfg, d, cfg.ffn_dim)
        self.fc2 = _linear(cfg, cfg.ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x, enc, self_bias, cross_bias,
                seed: Optional[int] = None):
        """Teacher forcing over the whole target x [B, L, D] (JAX
        seq2seq.py:307-325); seed: this layer's dropout seed (None: no
        dropout)."""
        gen = _seeded(seed, x.device)
        ln1 = self.self_attn_layer_norm
        ln2 = self.encoder_attn_layer_norm
        ln3 = self.final_layer_norm
        if self.pre_norm:
            y = ln1(x)
            x = x + _drop(self.self_attn(y, self_bias, kv_in=y), self.p, gen)
            x = x + _drop(self.encoder_attn(ln2(x), cross_bias, kv_in=enc),
                          self.p, gen)
            return x + _drop(_ffn(self, ln3(x), gen), self.p, gen)
        x = ln1(x + _drop(self.self_attn(x, self_bias, kv_in=x), self.p,
                          gen))
        x = ln2(x + _drop(self.encoder_attn(x, cross_bias, kv_in=enc),
                          self.p, gen))
        return ln3(x + _drop(_ffn(self, x, gen), self.p, gen))

    def step(self, x, position: int, self_cache, cross_kv, self_bias,
             cross_bias):
        """One incremental step, x [B, 1, D]: writes this position's K/V
        into the self cache in place (the cache is this call's own
        buffer), then attends over it and over the cached encoder K/V;
        pre- or post-norm (JAX seq2seq.py:327-353)."""
        k_cache, v_cache = self_cache
        ln1 = self.self_attn_layer_norm
        ln2 = self.encoder_attn_layer_norm
        ln3 = self.final_layer_norm
        y = ln1(x) if self.pre_norm else x
        k_t, v_t = self.self_attn.project_kv(y)
        k_cache[:, :, position:position + 1] = k_t
        v_cache[:, :, position:position + 1] = v_t
        y = self.self_attn(y, self_bias, cached_kv=(k_cache, v_cache))
        if self.pre_norm:
            x = x + y
            x = x + self.encoder_attn(ln2(x), cross_bias, cached_kv=cross_kv)
            return x + _ffn(self, ln3(x))
        x = ln1(x + y)
        x = ln2(x + self.encoder_attn(x, cross_bias, cached_kv=cross_kv))
        return ln3(x + _ffn(self, x))


class _Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _Backbone(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        d = cfg.d_model
        self.shared = (Int8Embed if cfg.weight_quant else nn.Embedding)(
            cfg.vocab_size, d)
        self.encoder = _Stack(EncoderLayer(cfg)
                              for _ in range(cfg.encoder_layers))
        self.decoder = _Stack(DecoderLayer(cfg)
                              for _ in range(cfg.decoder_layers))
        for side in (self.encoder, self.decoder):
            if cfg.learned_positions:
                side.embed_positions = nn.Embedding(
                    cfg.max_positions + cfg.position_offset, d)
            if cfg.embed_layernorm:
                side.layernorm_embedding = nn.LayerNorm(d, eps=1e-5)
            if cfg.pre_norm:
                side.layer_norm = nn.LayerNorm(d, eps=1e-5)


class Seq2Seq(nn.Module):
    """Encoder-decoder with a tied LM head (Pegasus / BigBird / BART)."""

    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        if cfg.sparse_impl not in SPARSE_IMPLS:
            raise ValueError(f"sparse_impl {cfg.sparse_impl!r}: one of "
                             f"{SPARSE_IMPLS}")
        self.cfg = cfg
        self.model = _Backbone(cfg)
        self.register_buffer("final_logits_bias",
                             torch.zeros(1, cfg.vocab_size))
        # float32 whatever the model's dtype (not a buffer, which .to()
        # would cast); copied to a device on first use there
        self._sin_pos = None if cfg.learned_positions else torch.from_numpy(
            sinusoidal_positions(cfg.max_positions, cfg.d_model))

    def _embed(self, side: nn.Module, ids: torch.Tensor,
               positions: torch.Tensor):
        """Token embedding (scaled by sqrt(d_model) where the config says),
        plus the position table, then the embedding LayerNorm where there
        is one (JAX seq2seq.py:446-462, 484-485). Pad tokens pass no
        gradient to the shared table (HF's padding_idx, JAX :454-455); the
        LM head's use of the table still does."""
        cfg = self.cfg
        x = self.model.shared(ids)
        if x.requires_grad:
            x = torch.where((ids == cfg.pad_token_id)[..., None], x.detach(),
                            x)
        if cfg.scale_embedding:
            x = x * math.sqrt(cfg.d_model)
        if cfg.learned_positions:
            x = x + side.embed_positions(positions + cfg.position_offset)
        else:
            if self._sin_pos.device != ids.device:
                self._sin_pos = self._sin_pos.to(ids.device)
            x = (_at_least_f32(x) + self._sin_pos[positions]).to(x.dtype)
        if cfg.embed_layernorm:
            x = side.layernorm_embedding(x)
        return x

    def _head(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.cfg.weight_quant:
            logits = self.model.shared.logits(hidden)
        else:
            logits = hidden @ self.model.shared.weight.t()
        return _at_least_f32(logits) + self.final_logits_bias.float()

    def _run(self, layer: nn.Module, *args):
        """One layer, under torch.utils.checkpoint with cfg.remat while
        gradients are recorded (its last argument is its dropout seed, so
        the recomputation draws the same masks)."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(layer, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return layer(*args)

    def encode_train(self, input_ids: torch.Tensor,
                     attention_mask: torch.Tensor, rand_maps=None,
                     generator: Optional[torch.Generator] = None,
                     dropout: Optional[bool] = None) -> torch.Tensor:
        """The encoder, with gradients where they are recorded and
        dropout from `generator` (JAX seq2seq.py:476-493); dropout None
        follows train() mode. rand_maps: optional per-layer list of numpy
        random-block maps for a block-sparse encoder; by default every
        layer uses the seed-0 map."""
        enc = self.model.encoder
        on = (self.training if dropout is None else dropout) \
            and self.cfg.dropout > 0
        seeds = _layer_seeds(generator, len(enc.layers) + 1, on)
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self._embed(enc, input_ids, pos[None])
        x = _drop(x, self.cfg.dropout, _seeded(seeds[0], x.device))
        bias = _mask_bias(attention_mask)
        for i, layer in enumerate(enc.layers):
            x = self._run(layer, x, bias, attention_mask,
                          None if rand_maps is None else rand_maps[i],
                          seeds[i + 1])
        return enc.layer_norm(x) if self.cfg.pre_norm else x

    @torch.no_grad()
    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               rand_maps=None) -> torch.Tensor:
        """encode_train without gradients or dropout (serving)."""
        return self.encode_train(input_ids, attention_mask, rand_maps,
                                 dropout=False)

    def decode(self, decoder_input_ids: torch.Tensor,
               enc_hidden: torch.Tensor, enc_mask: torch.Tensor,
               decoder_mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced decoding -> logits [B, L, V] in at least
        float32 (JAX seq2seq.py:495-513): causal self-attention, plus the
        decoder padding bias where decoder_mask is given, and the encoder
        padding bias on the cross attention."""
        dec = self.model.decoder
        on = self.training and self.cfg.dropout > 0
        seeds = _layer_seeds(generator, len(dec.layers) + 1, on)
        n = decoder_input_ids.shape[1]
        pos = torch.arange(n, device=decoder_input_ids.device)
        x = self._embed(dec, decoder_input_ids, pos[None])
        x = _drop(x, self.cfg.dropout, _seeded(seeds[0], x.device))
        self_bias = _causal_bias(n, x.device)
        if decoder_mask is not None:
            self_bias = self_bias + _mask_bias(decoder_mask)
        cross_bias = _mask_bias(enc_mask)
        for i, layer in enumerate(dec.layers):
            x = self._run(layer, x, enc_hidden, self_bias, cross_bias,
                          seeds[i + 1])
        if self.cfg.pre_norm:
            x = dec.layer_norm(x)
        return self._head(x)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                decoder_input_ids: torch.Tensor,
                decoder_attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced logits [B, L_dec, V] (JAX seq2seq.py:515-519);
        dropout in train() mode, drawn from `generator`."""
        enc = self.encode_train(input_ids, attention_mask,
                                generator=generator)
        return self.decode(decoder_input_ids, enc, attention_mask,
                           decoder_attention_mask, generator)

    @torch.no_grad()
    def init_cache(self, batch: int, max_len: int,
                   enc_hidden: torch.Tensor) -> Dict[str, List[Tuple]]:
        """Per-layer zeroed self K/V [B, H, max_len, hd] and the
        precomputed cross-attention K/V of enc_hidden (int8, with
        kv_quant; the self cache stays in the model dtype)."""
        cfg = self.cfg
        shape = (batch, cfg.num_heads, max_len, cfg.d_model // cfg.num_heads)
        mk = lambda: torch.zeros(shape, dtype=enc_hidden.dtype,  # noqa: E731
                                 device=enc_hidden.device)
        layers = self.model.decoder.layers
        cross = [layer.encoder_attn.project_kv(enc_hidden) for layer in layers]
        if cfg.kv_quant:
            cross = [quantize_kv(*kv) for kv in cross]
        return {"self": [(mk(), mk()) for _ in layers], "cross": cross}

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, position: int, cache,
                    enc_mask: torch.Tensor, max_len: int):
        """token [B, 1] at `position` -> (logits [B, V] float32, cache);
        the self caches update in place."""
        dec = self.model.decoder
        x = self._embed(dec, token, torch.full_like(token, position))
        key_pos = torch.arange(max_len, device=token.device)
        self_bias = torch.where(key_pos <= position, 0.0, NEG_INF)
        cross_bias = _mask_bias(enc_mask)
        for i, layer in enumerate(dec.layers):
            x = layer.step(x, position, cache["self"][i], cache["cross"][i],
                           self_bias, cross_bias)
        if self.cfg.pre_norm:
            x = dec.layer_norm(x)
        return self._head(x)[:, 0], cache


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the top-k logits of each row, set the rest to -inf (JAX
    seq2seq.py:573-578; ties at the k-th value are all kept)."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


@torch.no_grad()
def generate(model: Seq2Seq, input_ids: torch.Tensor,
             attention_mask: torch.Tensor, max_len: int = 30,
             temperature: float = 1.0, sample: bool = False,
             top_k: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             enc_hidden: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KV-cached decoding from decoder_start_token_id for exactly max_len
    steps (JAX seq2seq.py:581-650): each step divides the logits by
    `temperature`, keeps the top_k of them when given, and takes the
    argmax (greedy, the default) or, with sample=True, draws from their
    softmax with `generator` (a torch.Generator on the model's device, in
    place of the JAX rng). After a row's first EOS every later token is
    EOS. enc_hidden replaces the encoder output (the JAX
    enc_hidden_override: Seq2SeqVisionEmb.encode_fused's states).
    Returns ids [B, max_len] int64."""
    cfg = model.cfg
    enc = (model.encode(input_ids, attention_mask) if enc_hidden is None
           else enc_hidden)
    b = input_ids.shape[0]
    cache = model.init_cache(b, max_len, enc)
    token = torch.full((b, 1), cfg.decoder_start_token_id, dtype=torch.long,
                       device=input_ids.device)
    done = torch.zeros(b, dtype=torch.bool, device=input_ids.device)
    ids = []
    for pos in range(max_len):
        logits, cache = model.decode_step(token, pos, cache, attention_mask,
                                          max_len)
        scaled = logits / temperature
        if top_k is not None:
            scaled = top_k_filter(scaled, top_k)
        if sample:
            nxt = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                    generator=generator)[:, 0]
        else:
            nxt = scaled.argmax(dim=-1)
        nxt = torch.where(done, cfg.eos_token_id, nxt)
        done = done | (nxt == cfg.eos_token_id)
        ids.append(nxt)
        token = nxt[:, None]
    return torch.stack(ids, dim=1)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k over the last axis: the k largest values in
    descending order, the lower index first among equal values (a stable
    sort; torch.topk promises no tie order, and the -1e9 masks of the
    beam search make ties common: float32 spacing there is 64)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def beam_search(model: Seq2Seq, input_ids: torch.Tensor,
                attention_mask: torch.Tensor, num_beams: int = 4,
                max_len: int = 30, length_penalty: float = 1.0,
                enc_hidden: Optional[torch.Tensor] = None,
                early_stopping: Union[bool, str] = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HuggingFace's static beam search (JAX seq2seq.py:870-1033), step
    for step: the n running beams expand to the top 2n candidates by
    accumulated log-prob; candidates that finish (EOS, or the last step)
    and rank in the top n bank into a finished pool of n, scored
    sum_logp / n_generated ** length_penalty frozen at bank time; the
    next running beams are the best candidates with finished ones pushed
    down by an additive -1e9. HF's stopping rules are latched gates on
    banking: early_stopping=True blocks it once the pool is full,
    False and "never" once the best running beam can no longer beat the
    worst finished one (with "never", at the longest length). Like the
    JAX scan, the loop runs all max_len steps. Scores, sentinels and the
    length normalisation are float32 whatever the model's dtype.
    Returns (ids [B, max_len] int64, EOS-padded past the end, scores [B]
    float32) of the best finished beam."""
    cfg = model.cfg
    eos = cfg.eos_token_id
    b, n = input_ids.shape[0], num_beams
    n2 = 2 * n  # HF beams_to_keep = max(2, 1 + n_eos) * num_beams
    enc = (model.encode(input_ids, attention_mask) if enc_hidden is None
           else enc_hidden)
    dev = enc.device
    f32 = torch.float32
    enc = enc.repeat_interleave(n, dim=0)  # [B*n, L, D]
    mask = attention_mask.repeat_interleave(n, dim=0)
    cache = model.init_cache(b * n, max_len, enc)

    # running pool: beam 0 active, the rest at -1e9, so step 0 fans out
    # from it; slot 0 of the token buffers is the start token, slot p+1 is
    # written at step p, EOS past the end
    run_scores = torch.tensor([0.0] + [NEG_INF] * (n - 1), dtype=f32,
                              device=dev).repeat(b, 1)
    run_tokens = torch.full((b, n, max_len + 1), eos, dtype=torch.long,
                            device=dev)
    run_tokens[:, :, 0] = cfg.decoder_start_token_id
    fin_tokens = run_tokens.clone()  # kept sorted by the merge's top-k
    fin_scores = torch.full((b, n), NEG_INF, dtype=f32, device=dev)
    fin_done = torch.zeros((b, n), dtype=torch.bool, device=dev)
    improving = torch.ones((b, 1), dtype=torch.bool, device=dev)
    top_mask = torch.arange(n2, device=dev) < n  # HF top_num_beam_mask
    rows = torch.arange(b, device=dev)[:, None] * n
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)

    def take(x, idx):  # x [b, m, ...] gathered along m by idx [b, k]
        return x[torch.arange(b, device=dev)[:, None], idx]

    for pos in range(max_len):
        last = run_tokens[:, :, pos].reshape(b * n, 1)
        logits, cache = model.decode_step(last, pos, cache, mask, max_len)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, n, -1)
        v = logp.shape[-1]
        acc = (run_scores[:, :, None] + logp).reshape(b, n * v)
        top_lp, flat_idx = _top_k(acc, n2)
        beam_idx = flat_idx // v
        tok = flat_idx % v
        top_seqs = take(run_tokens, beam_idx)
        top_seqs[:, :, pos + 1] = tok
        hits = (tok == eos) | (pos == max_len - 1)

        # next running beams: finished candidates get an additive -1e9
        run_lp = top_lp + hits.to(f32) * NEG_INF
        _, next_idx = _top_k(run_lp, n)
        run_tokens = take(top_seqs, next_idx)
        run_scores = take(run_lp, next_idx)
        flat = (rows + take(beam_idx, next_idx)).reshape(-1)
        # decode_step writes the self caches in place: each layer's (k, v)
        # becomes a gathered copy. The cross caches hold the same rows for
        # every beam of a video (enc was repeated per beam), so a gather
        # would change nothing: they stay as they are
        cache["self"] = [(k.index_select(0, flat), v_.index_select(0, flat))
                         for k, v_ in cache["self"]]

        # the finished pool (HF _update_finished_beams, in its order)
        pos_f = torch.tensor(pos + 1, dtype=f32, device=dev)
        norm_lp = top_lp / pos_f ** length_penalty
        if early_stopping is True:
            full = fin_done.all(dim=-1, keepdim=True)
            norm_lp = norm_lp + full.to(f32) * NEG_INF
        norm_lp = norm_lp + (~improving).to(f32) * NEG_INF
        just_fin = hits & top_mask[None, :]
        norm_lp = norm_lp + (~just_fin).to(f32) * NEG_INF
        m_scores = torch.cat([fin_scores, norm_lp], dim=1)
        m_tokens = torch.cat([fin_tokens, top_seqs], dim=1)
        m_done = torch.cat([fin_done, just_fin], dim=1)
        fin_scores, m_idx = _top_k(m_scores, n)
        fin_tokens = take(m_tokens, m_idx)
        fin_done = take(m_done, m_idx)

        # HF _check_early_stop_heuristic, after the length increment
        if early_stopping == "never" and length_penalty > 0.0:
            best_len = torch.tensor(float(max_len), dtype=f32, device=dev)
        else:
            best_len = pos_f
        best_possible = run_scores[:, :1] / best_len ** length_penalty
        worst_fin = torch.where(
            fin_done, fin_scores.min(dim=1, keepdim=True).values, neg)
        improving = improving & (best_possible > worst_fin).any(
            dim=-1, keepdim=True)

    # the finished pool is sorted descending: slot 0 is HF's result
    return fin_tokens[:, 0, 1:], fin_scores[:, 0]


def trim_at_eos(ids, eos_token_id: int):
    """Host-side: cut each id row at (and including) its first EOS."""
    out = []
    for row in np.asarray(ids):
        row = list(row)
        if eos_token_id in row:
            row = row[: row.index(eos_token_id) + 1]
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# the vision-conditioned variant (JAX seq2seq.py:670-772)
# ---------------------------------------------------------------------------


class VisualLangCrossAttention(nn.Module):
    """Language queries attend over vision tokens (JAX :670-693). The key
    mask MULTIPLIES the scores (a masked key scores 0, it still takes
    softmax weight), as the reference does (pegasus_vision_emb.py:55)."""

    def __init__(self, n_embd: int, n_head: int, output_size: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_embd, n_embd)
        self.key = nn.Linear(n_embd, n_embd)
        self.value = nn.Linear(n_embd, n_embd)
        self.proj = nn.Linear(n_embd, output_size)

    def forward(self, query_states: torch.Tensor, key_value_states,
                kv_attention_mask: Optional[torch.Tensor] = None):
        b, t1, c = query_states.shape
        t2 = key_value_states.shape[1]
        hd = c // self.n_head
        q = self.query(query_states).reshape(b, t1, self.n_head, hd)
        k = self.key(key_value_states).reshape(b, t2, self.n_head, hd)
        v = self.value(key_value_states).reshape(b, t2, self.n_head, hd)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        if kv_attention_mask is not None:
            att = att * kv_attention_mask[:, None, None, :].to(att.dtype)
        att = torch.softmax(att.float(), dim=-1).to(v.dtype)
        y = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, t1, c)
        return self.proj(y)


class VisionFusionHead(nn.Module):
    """Project the language states and the chapter's vision embeddings to
    hidden_size, fuse them, map back to the language width (JAX
    :696-732). "cross_attn": VisualLangCrossAttention with 8 heads;
    "mlp": the masked mean of the vision tokens, broadcast over the
    language positions and concatenated before them, through a bias-free
    Linear (the JAX package's form of the reference's dead branch)."""

    def __init__(self, lang_emb_size: int, vision_emb_size: int = 2048,
                 hidden_size: int = 128, fusion_type: str = "cross_attn"):
        super().__init__()
        if fusion_type not in FUSION_TYPES:
            raise ValueError(f"fusion_type {fusion_type!r}: one of "
                             f"{FUSION_TYPES}")
        self.fusion_type, self.hidden_size = fusion_type, hidden_size
        self.lang_proj_head = nn.Linear(lang_emb_size, hidden_size,
                                        bias=False)
        self.vision_proj_head = nn.Linear(vision_emb_size, hidden_size,
                                          bias=False)
        if fusion_type == "mlp":
            self.fusion_head = nn.Linear(2 * hidden_size, lang_emb_size,
                                         bias=False)
        else:
            self.fusion_head = VisualLangCrossAttention(hidden_size, 8,
                                                        lang_emb_size)

    def forward(self, lang_emb: torch.Tensor, vision_emb: torch.Tensor,
                vision_attention_mask: Optional[torch.Tensor] = None):
        lang = torch.relu(self.lang_proj_head(lang_emb))
        vision = torch.relu(self.vision_proj_head(vision_emb))
        if self.fusion_type == "cross_attn":
            return self.fusion_head(lang, vision, vision_attention_mask)
        if vision_attention_mask is None:
            pooled = vision.mean(dim=1)
        else:
            m = vision_attention_mask[..., None].to(vision.dtype)
            pooled = (vision * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
        pooled = pooled[:, None].expand(*lang.shape[:-1], self.hidden_size)
        return self.fusion_head(torch.cat([pooled, lang], dim=-1))



class Seq2SeqVisionEmb(nn.Module):
    """PegasusVisionEmb (JAX :735-772): the encoder output plus the fusion
    head's output over the chapter's vision embeddings, then the inner
    Seq2Seq's decoder. The fusion width is 128 for "mlp" and d_model for
    "cross_attn", as in the reference."""

    def __init__(self, cfg: Seq2SeqConfig, fusion_type: str = "cross_attn",
                 vision_emb_size: int = 2048):
        super().__init__()
        self.cfg = cfg
        self.seq2seq = Seq2Seq(cfg)
        self.fusion_head = VisionFusionHead(
            cfg.d_model, vision_emb_size,
            128 if fusion_type == "mlp" else cfg.d_model, fusion_type)

    def encode_fused_train(self, vision_emb: torch.Tensor,
                           vision_attention_mask: torch.Tensor,
                           input_ids: torch.Tensor,
                           attention_mask: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           dropout: Optional[bool] = None) -> torch.Tensor:
        """The encoder states plus the fusion head's output over the
        vision embeddings (JAX :756-760), with gradients where they are
        recorded and the encoder's dropout (None: in train() mode)."""
        enc = self.seq2seq.encode_train(input_ids, attention_mask,
                                        generator=generator, dropout=dropout)
        fused = self.fusion_head(enc, vision_emb.to(enc.dtype),
                                 vision_attention_mask)
        return fused + enc

    @torch.no_grad()
    def encode_fused(self, vision_emb: torch.Tensor,
                     vision_attention_mask: torch.Tensor,
                     input_ids: torch.Tensor,
                     attention_mask: torch.Tensor) -> torch.Tensor:
        """vision_emb [B, V, D_v] (cast to the encoder's dtype),
        vision_attention_mask [B, V] -> fused encoder states [B, L, D],
        for generate / beam_search on self.seq2seq as enc_hidden."""
        return self.encode_fused_train(vision_emb, vision_attention_mask,
                                       input_ids, attention_mask,
                                       dropout=False)

    def forward(self, vision_emb: torch.Tensor,
                vision_attention_mask: torch.Tensor,
                input_ids: torch.Tensor, attention_mask: torch.Tensor,
                decoder_input_ids: torch.Tensor,
                decoder_attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced logits over the fused encoder states (JAX
        :762-772)."""
        enc = self.encode_fused_train(vision_emb, vision_attention_mask,
                                      input_ids, attention_mask, generator)
        return self.seq2seq.decode(decoder_input_ids, enc, attention_mask,
                                   decoder_attention_mask, generator)
