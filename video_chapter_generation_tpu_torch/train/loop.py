"""The generic training loop (counterpart of the JAX package's
train/loop.py:77-226): the same epoch loop, per-epoch LR multiplier,
StepTimer "train_step", eval hook, save cadence and resume, on one
device, or data-parallel over the processes of a torch.distributed
group (the JAX Trainer's ('data', 'model') mesh, a process a device).

Data-parallel (a process group of W processes, mesh.model_axis = m
dividing W; m changes nothing but the data axis, as in the JAX Trainer,
whose model axis replicates the parameters): the W / m processes of a
model index form the data group (parallel/dist.py:data_groups). Each
takes its rows of the global batch (its loader is a
parallel/loader.py:RankLoader), so a step sees the global batch of a
one-process run. The parameters are equal by seed on every process (the
Trainer asserts it); BatchNorm takes the data group's moments at every
site (a MomentGroup made current for the step: the plain route through
bn_train, the kernels K11-K13 split at their moments); the gradients of
each process's mean loss are averaged over the group once per update
(bucketed all_reduce, after the zero gradients of unused parameters),
which gives the gradient of the global batch's mean loss, then clipped
by their global norm alike everywhere. With mesh.shard_opt_state (the
default) the optimizer state is ZeRO-sharded (train/optim.py
:ZeroOptimizer). The dropout generator is seeded from (train.seed, data
index): train.seed itself for index 0. The logged metrics are the
group's means; the primary process (rank 0) alone evaluates (the score
is broadcast), logs and writes checkpoints, which hold the whole
optimizer state in the one-process layout (any process count resumes
them); every process waits for the write.

With optim.gradient_accumulation_steps = k > 1 a
train step is a micro-step: one update every k of them, as under the
JAX package's optax.MultiSteps (loop.py:9), with `step` counting
micro-steps as the JAX TrainState does. Each micro-step adds the
gradient of loss / k to .grad, so the update sees the mean of the k
micro-batch gradients; a checkpoint taken mid-cycle keeps the .grad
sums (their mean over the data group), and training resumes mid-cycle.

task provides: model (built on the meta device), entries (models/convert
table), init_state() -> state dict, loss_fn(model, batch, generator) ->
(loss, metrics), optionally eval_fn(model, loader) -> (score, metrics)
and a contract dict. Loaders are callables epoch -> iterable of host
batch dicts.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from ..core.checkpoint import CheckpointManager
from ..core.config import Config
from ..core.metrics import MetricWriter, StepTimer
from ..device import resolve_device
from ..parallel import dist
from .optim import (
    ZeroOptimizer,
    clipped_step,
    fill_grads,
    lr_multiplier,
    make_optimizer,
    set_lr_mult,
)

logger = logging.getLogger(__name__)

# seeds of the data indices' dropout generators: train.seed + this * index
_SEED_STRIDE = 1_000_003


class _NoWriter:
    """The metric writer of a process that logs nothing."""

    def add_scalar(self, *args) -> None:
        pass


def _fingerprint(t: torch.Tensor) -> tuple:
    """Two float64 sums that tell tensors apart (equal tensors give equal
    sums on the same kind of device)."""
    v = t.detach().double().reshape(-1)
    ramp = torch.arange(1, v.numel() + 1, dtype=torch.float64,
                        device=v.device)
    return float(v.sum()), float((v * ramp).sum())


@dataclasses.dataclass
class Trainer:
    cfg: Config
    task: Any
    train_loader: Callable[[int], Iterable]
    eval_loader: Optional[Callable[[int], Iterable]] = None
    device: Optional[Any] = None

    def __post_init__(self):
        if self.device is None and dist.process_count() > 1:
            resolve_device(None)  # raises without CUDA
            self.device = dist.default_device()
        self.device = resolve_device(self.device)
        (self.data_group, host_group, self.data_index,
         self.data_count) = dist.data_groups(self.cfg.mesh.model_axis)
        if self.cfg.mesh.data_axis not in (-1, self.data_count):
            raise ValueError(f"mesh.data_axis={self.cfg.mesh.data_axis}: the "
                             f"data axis spans the {self.data_count} "
                             "processes of a model index (-1)")
        self.primary = dist.is_primary()
        self.moments = (dist.MomentGroup(self.data_group, host_group)
                        if self.data_count > 1 else None)
        self.model = self.task.model
        self.model.load_state_dict(self.task.init_state(), assign=True)
        self.model.to(self.device).train()
        if dist.process_count() > 1:
            self._check_replicas()
        self.opt = make_optimizer(self.cfg.optim, self.model,
                                  self.task.entries)
        if self.data_count > 1 and self.cfg.mesh.shard_opt_state:
            self.opt = ZeroOptimizer(self.opt, self.model, self.data_group,
                                     self.data_index, self.data_count)
        self.ckpt = CheckpointManager(self.cfg.train.ckpt_dir,
                                      max_to_keep=self.cfg.train.keep_checkpoints)
        self.writer = (MetricWriter(self.cfg.train.log_dir) if self.primary
                       else _NoWriter())
        self.timer = StepTimer()
        # dropout masks: one generator on the device, seeded from
        # (train.seed, data index); processes of one data index (the model
        # axis) draw the same masks, as their rows are the same
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.cfg.train.seed
                                   + _SEED_STRIDE * self.data_index)
        self.best_result = float("-inf")
        self.start_epoch = 0
        self.step = 0
        if self.cfg.train.resume:
            self._try_resume()

    def _check_replicas(self) -> None:
        """Every process starts from the same parameters and buffers (they
        are equal by seed): every process raises where one differs from
        the primary's."""
        mine = [(k, _fingerprint(v)) for k, v in
                self.model.state_dict().items() if v.is_floating_point()]
        theirs = dist.broadcast_object(mine)
        bad = [k for (k, a), (_, b) in zip(mine, theirs) if a != b]
        every = dist.all_gather_object(bad[:5])
        if any(every):
            raise RuntimeError("the processes start from other weights than "
                               f"process 0: {every}")

    # -- checkpoint ------------------------------------------------------
    def state(self) -> Dict[str, Any]:
        """The checkpoint's state (collective under a process group: the
        optimizer state is gathered, the mid-cycle gradient sums averaged
        over the data group)."""
        out = {"model": self.model.state_dict(),
               "optimizer": self.opt.state_dict(), "step": self.step}
        if self.step % self.cfg.optim.gradient_accumulation_steps:
            grads = {n: p.grad for n, p in self.model.named_parameters()
                     if p.grad is not None}
            if self.data_count > 1:
                grads = {n: g.clone() for n, g in grads.items()}
                dist.mean_tensors_(grads.values(), self.data_group)
            out["grads"] = grads
        return out

    def _try_resume(self):
        restored = self.ckpt.restore_latest()
        if restored is None:
            return
        epoch, state = restored
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["optimizer"])
        params = dict(self.model.named_parameters())
        for name, grad in state.get("grads", {}).items():
            params[name].grad = grad.to(params[name].device)
        self.step = int(state["step"])
        self.best_result = float(self.ckpt.metrics_for(epoch).get(
            "best_result", self.best_result))
        self.start_epoch = epoch + 1
        logger.info("resumed from checkpoint at epoch %d", epoch)

    # -- loops -----------------------------------------------------------
    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        k = self.cfg.optim.gradient_accumulation_steps
        if self.step % k == 0:  # the first micro-step of an update
            self.opt.zero_grad(set_to_none=True)
        with dist.use_moments(self.moments):
            loss, metrics = self.task.loss_fn(self.model, batch,
                                              self.generator)
            (loss / k).backward()
        self.step += 1
        if self.step % k:
            return metrics
        # a parameter the loss does not reach (the pooler under the MLM
        # head) still decays
        params = fill_grads(self.model.parameters())
        if self.data_count > 1:
            # the mean of the processes' gradients: that of the global
            # batch's mean loss
            dist.mean_tensors_([p.grad for p in params], self.data_group)
        clipped_step(self.opt, params, self.cfg.optim.grad_norm_clip)
        return metrics

    def run_epoch(self, epoch: int) -> Dict[str, float]:
        mult = lr_multiplier(epoch, self.cfg.optim)
        set_lr_mult(self.opt, self.cfg.optim, mult)
        self.model.train()
        agg: Dict[str, float] = {}
        count = 0
        for batch in self.train_loader(epoch):
            self.timer.start("train_step")
            metrics = self.train_step(batch)
            if self.data_count > 1 and metrics:  # the group's means
                names = list(metrics)
                vec = torch.stack([metrics[k].detach().double()
                                   for k in names])
                dist.mean_tensors_([vec], self.data_group)
                metrics = dict(zip(names, vec))
            values = {k: float(v.detach()) for k, v in metrics.items()}  # syncs
            n = len(next(iter(batch.values())))
            self.timer.stop("train_step", n)
            count += 1
            for k, v in values.items():
                agg[k] = agg.get(k, 0.0) + v
        if count:
            agg = {k: v / count for k, v in agg.items()}
        agg["lr_mult"] = mult
        for k, v in agg.items():
            self.writer.add_scalar(f"train/{k}", v, epoch)
        return agg

    def train(self) -> Dict[str, float]:
        last: Dict[str, float] = {}
        for epoch in range(self.start_epoch, self.cfg.train.max_epochs):
            t0 = time.time()
            last = self.run_epoch(epoch)
            score = None
            if (self.eval_loader is not None
                    and hasattr(self.task, "eval_fn")
                    and (epoch + 1) % self.cfg.train.eval_every_epochs == 0):
                if self.primary:
                    self.model.eval()
                    score, eval_metrics = self.task.eval_fn(
                        self.model, self.eval_loader(epoch))
                    for k, v in eval_metrics.items():
                        self.writer.add_scalar(f"eval/{k}", v, epoch)
                score = dist.broadcast_object(score)
                if score > self.best_result:
                    self.best_result = score
            if ((epoch + 1) % self.cfg.train.save_every_epochs == 0
                    or epoch == self.cfg.train.max_epochs - 1
                    or score is not None):
                state = self.state()
                if self.primary:
                    self.ckpt.save(epoch, state, score=score, metrics={
                        "best_result": self.best_result,
                        "contract": getattr(self.task, "contract", {})})
                del state
                dist.barrier("checkpoint")
            logger.info("epoch %d done in %.1fs: %s", epoch,
                        time.time() - t0, last)
        return last
