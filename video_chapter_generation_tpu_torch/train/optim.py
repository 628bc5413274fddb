"""The optimizer recipe of the JAX package's train/optim.py in torch:

    optax.chain(clip_by_global_norm_ref(clip), scale_by_adam(b1, b2),
                add_decayed_weights(wd, mask), scale(-lr), scale(lr_mult))

is torch.nn.utils.clip_grad_norm_ (it divides by norm + 1e-6, as
clip_by_global_norm_ref does) followed by torch.optim.AdamW with the
decay and no-decay parameters in two groups and lr = learning_rate *
lr_mult (AdamW's decoupled decay multiplies by that lr, as the optax chain
scales the decayed weights by it).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from ..core.config import OptimConfig

_NO_DECAY_MARKERS = ("ln", "norm", "bn", "emb")


def decays(jax_path: Sequence[str]) -> bool:
    """True where weight decay applies to the parameter at this path of
    the JAX package's params tree: the rule of train/optim.py:45-60,
    quirks included (biases never decay; norm scales do not, except the
    projection BN and the fusion-head norms; kernels decay unless the
    path names a norm, a BN or an embedding)."""
    keys = [str(k) for k in jax_path]
    leaf = keys[-1].lower()
    joined = "/".join(k.lower() for k in keys)
    if leaf.endswith("bias"):
        return False
    if leaf == "scale":
        if "proj_bn" in joined:
            return True
        return "window_attn" in joined or "fusion_head" in joined
    if leaf != "kernel":
        return False
    return not any(m in joined for m in _NO_DECAY_MARKERS)


def no_decay_mask(model: torch.nn.Module, entries) -> Dict[str, bool]:
    """Port parameter name -> whether it decays, by the JAX rule applied
    to the parameter's JAX path (entries: models/convert.py's table for
    the model, (jax path, port key, kind))."""
    paths = {key: path[1:] for path, key, _ in entries if path[0] == "params"}
    mask = {}
    for name, _ in model.named_parameters():
        if name not in paths:
            raise KeyError(f"{name} has no JAX path in the entry table")
        mask[name] = decays(paths[name])
    return mask


def lr_multiplier(epoch: int, cfg: OptimConfig) -> float:
    """Epoch-based schedule multiplier (train/optim.py:65)."""
    if not cfg.lr_decay:
        return 1.0
    if epoch < cfg.warmup_epochs:
        return max(epoch / cfg.warmup_epochs, 1e-2)
    progress = epoch / cfg.final_epochs if epoch < cfg.final_epochs else 1.0
    if cfg.lr_decay_type == "cosine":
        return max(0.001, 0.5 * (1.0 + math.cos(math.pi * progress)))
    if cfg.lr_decay_type == "exp":
        t = 1 / 5
        if progress < t:
            return 1.0
        if progress < 2 * t:
            return 0.1
        if progress < 3 * t:
            return 0.01
        return 0.001
    raise ValueError(f"unknown lr_decay_type {cfg.lr_decay_type}")


def make_optimizer(cfg: OptimConfig, model: torch.nn.Module,
                   entries) -> torch.optim.AdamW:
    """AdamW with the JAX package's decay partition (train/optim.py:109).
    Set the per-epoch multiplier with set_lr_mult."""
    if cfg.gradient_accumulation_steps > 1:
        raise NotImplementedError(
            "gradient_accumulation_steps > 1 is not ported yet")
    mask = no_decay_mask(model, entries)
    params = dict(model.named_parameters())
    groups = [
        {"params": [params[n] for n in params if mask[n]],
         "weight_decay": cfg.weight_decay},
        {"params": [params[n] for n in params if not mask[n]],
         "weight_decay": 0.0},
    ]
    return torch.optim.AdamW(groups, lr=cfg.learning_rate,
                             betas=tuple(cfg.betas), eps=1e-8)


def set_lr_mult(opt: torch.optim.Optimizer, cfg: OptimConfig,
                mult: float) -> None:
    for group in opt.param_groups:
        group["lr"] = cfg.learning_rate * mult

