"""The optimizer recipe of the JAX package's train/optim.py in torch:

    optax.chain(clip_by_global_norm_ref(clip), scale_by_adam(b1, b2),
                add_decayed_weights(wd, mask), scale(-lr), scale(lr_mult))

is torch.nn.utils.clip_grad_norm_ (it divides by norm + 1e-6, as
clip_by_global_norm_ref does) followed by torch.optim.AdamW with the
decay and no-decay parameters in two groups and lr = learning_rate *
lr_mult (AdamW's decoupled decay multiplies by that lr, as the optax chain
scales the decayed weights by it). gradient_accumulation_steps = k > 1
wraps that chain in optax.MultiSteps (train/optim.py:129-130): the
Trainer (train/loop.py) sums each micro-batch's gradient of loss / k in
.grad and takes one clip and one AdamW step every k micro-steps, on the
mean of the k gradients.
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


def _param_paths(entries) -> Dict[str, Sequence[str]]:
    """Port parameter name -> its JAX path under "params" (entries:
    models/convert.py's table for the model, (jax path, port key, kind))."""
    # a tree with BatchNorm holds {"params", "batch_stats"}; the title
    # models' tables are rooted at their params
    return {key: path[1:] if path[0] == "params" else path
            for path, key, _ in entries if path[0] != "batch_stats"}


def no_decay_mask(model: torch.nn.Module, entries) -> Dict[str, bool]:
    """Port parameter name -> whether it decays, by the JAX rule applied
    to the parameter's JAX path under "params"."""
    paths = _param_paths(entries)
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
    Set the per-epoch multiplier with set_lr_mult; with
    gradient_accumulation_steps > 1 the caller steps it once every k
    micro-steps."""
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


def make_grouped_optimizer(cfg: OptimConfig, model: torch.nn.Module,
                           entries,
                           backbone_markers=("lang_model", "vision_model"),
                           head_lr_mult: float = 2.0) -> torch.optim.AdamW:
    """The domain-specific recipe (train/optim.py:148): backbone parameters
    (a JAX path that names one of backbone_markers) at the base rate,
    every other parameter at head_lr_mult times it, with the decay /
    no-decay split of make_optimizer inside each group.

    The JAX chain multiplies the whole update by the group's multiplier
    after add_decayed_weights, so the weight decay term is scaled too.
    Here the multiplier is the AdamW group's learning rate (its
    "lr_scale" times learning_rate * lr_mult, see set_lr_mult), and
    AdamW's decoupled decay multiplies by that rate: both terms scale
    the same way."""
    mask = no_decay_mask(model, entries)
    paths = _param_paths(entries)
    params = dict(model.named_parameters())

    def is_backbone(name) -> bool:
        joined = "/".join(str(k).lower() for k in paths[name])
        return any(m in joined for m in backbone_markers)

    groups = []
    for backbone in (True, False):
        scale = 1.0 if backbone else head_lr_mult
        for decay in (True, False):
            names = [n for n in params
                     if is_backbone(n) == backbone and mask[n] == decay]
            if names:
                groups.append({
                    "params": [params[n] for n in names],
                    "weight_decay": cfg.weight_decay if decay else 0.0,
                    "lr_scale": scale, "lr": cfg.learning_rate * scale})
    return torch.optim.AdamW(groups, lr=cfg.learning_rate,
                             betas=tuple(cfg.betas), eps=1e-8)


def set_lr_mult(opt: torch.optim.Optimizer, cfg: OptimConfig,
                mult: float) -> None:
    """Every group's rate to learning_rate * mult, times the group's
    "lr_scale" where it has one (make_grouped_optimizer)."""
    for group in opt.param_groups:
        group["lr"] = cfg.learning_rate * mult * group.get("lr_scale", 1.0)


class ZeroOptimizer:
    """ZeRO-sharded optimizer state over the data axis (the JAX Trainer's
    mesh.shard_opt_state, train/loop.py:129-140): `opt` (make_optimizer's
    or make_grouped_optimizer's AdamW) rebuilt with each parameter that
    parallel/mesh.py:shard_params_zero shards (along the dim it names, in
    the port's layouts) replaced by this process's slice of it, a view
    into the parameter, so that AdamW keeps exp_avg and exp_avg_sq of the
    slice only; the entries it leaves replicated (under 2^14 elements, or
    no dim the process count divides) stay whole, updated alike on every
    process. `step` updates the slices from the averaged gradient, then
    all-gathers each sharded parameter over the group. The groups keep
    their options (weight decay, "lr_scale"), so set_lr_mult works on
    `param_groups`.

    `state_dict` gathers the whole state in the layout a one-process
    AdamW has (collective: every process calls it), and
    `load_state_dict` takes that layout and keeps this process's slices:
    a checkpoint written by W processes resumes in any number."""

    def __init__(self, opt: torch.optim.Optimizer, model: torch.nn.Module,
                 group, index: int, count: int):
        from ..parallel.mesh import make_mesh, shard_params_zero

        names = {id(p): n for n, p in model.named_parameters()}
        dims = shard_params_zero(make_mesh(data=count,
                                           devices=["cpu"] * count),
                                 dict(model.named_parameters()))
        self.group, self.index, self.count = group, index, count
        self.params = [p for g in opt.param_groups for p in g["params"]]
        # per parameter of the groups, in order: (param, dim or None)
        self.layout = [(p, dims[names[id(p)]]) for p in self.params]
        groups = []
        for g in opt.param_groups:
            groups.append(dict(g, params=[
                self._slice(p, dims[names[id(p)]]) for p in g["params"]]))
        self.inner = type(opt)(groups, lr=opt.defaults["lr"])

    def _slice(self, t: torch.Tensor, dim, index=None) -> torch.Tensor:
        """This process's part of t along dim (a view; t itself for None)."""
        if dim is None:
            return t
        size = t.shape[dim] // self.count
        i = self.index if index is None else index
        return t.detach().narrow(dim, i * size, size)

    @property
    def param_groups(self):
        return self.inner.param_groups

    def state_bytes(self) -> int:
        """Bytes of this process's optimizer state."""
        return sum(t.numel() * t.element_size()
                   for st in self.inner.state.values()
                   for t in st.values() if torch.is_tensor(t))

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        sliced = [(p, d, v) for (p, d), v in
                  zip(self.layout, (q for g in self.inner.param_groups
                                    for q in g["params"]))
                  if d is not None]
        for p, d, v in sliced:
            v.grad = self._slice(p.grad, d)
        self.inner.step()
        self._gather([(p, d) for p, d, _ in sliced])

    def _gather(self, sliced) -> None:
        """Every process's slices into the whole parameters, one
        all_gather a bucket (parallel/dist.py:buckets) of each
        process."""
        import torch.distributed as tdist

        from ..parallel.dist import buckets

        for run in buckets([self._slice(p, d) for p, d in sliced]):
            flat = torch.cat([v.reshape(-1) for v in run])
            parts = [torch.empty_like(flat) for _ in range(self.count)]
            tdist.all_gather(parts, flat, group=self.group)
            at = 0
            for v in run:
                p, d = sliced.pop(0)
                for r, part in enumerate(parts):
                    self._slice(p, d, r).copy_(
                        part[at:at + v.numel()].view(v.shape))
                at += v.numel()

    def _whole(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        import torch.distributed as tdist

        parts = [torch.empty_like(t) for _ in range(self.count)]
        tdist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def state_dict(self):
        """The one-process layout (collective)."""
        sd = self.inner.state_dict()
        state = {}
        for i, st in sd["state"].items():
            d = self.layout[i][1]
            state[i] = {k: (self._whole(v, d) if d is not None
                            and torch.is_tensor(v) and v.dim() else v)
                        for k, v in st.items()}
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, sd) -> None:
        """From the one-process layout: this process's slices."""
        state = {}
        for i, st in sd["state"].items():
            d = self.layout[int(i)][1]
            state[i] = {k: (self._slice(v, d).clone() if d is not None
                            and torch.is_tensor(v) and v.dim() else v)
                        for k, v in st.items()}
        self.inner.load_state_dict({"state": state,
                                    "param_groups": sd["param_groups"]})


def fill_grads(params) -> list:
    """params as a list, each parameter the loss did not reach given a
    zero gradient: optax updates every leaf, so such a parameter still
    decays, as under AdamW with a zero gradient (AdamW skips a parameter
    without one)."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return params


def clipped_step(opt: torch.optim.Optimizer, params, max_norm: float) -> None:
    """One update of the JAX chain: the gradients filled (fill_grads),
    their global norm clipped to max_norm (divided by norm + 1e-6, as
    clip_by_global_norm_ref), then opt steps."""
    params = fill_grads(params)
    torch.nn.utils.clip_grad_norm_(params, max_norm)
    opt.step()
