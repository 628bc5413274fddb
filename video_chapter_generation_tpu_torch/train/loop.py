"""The generic training loop (counterpart of the JAX package's
train/loop.py:77-226): the same epoch loop, per-epoch LR multiplier,
StepTimer "train_step", eval hook, save cadence and resume, on one
device (no mesh). With optim.gradient_accumulation_steps = k > 1 a
train step is a micro-step: one update every k of them, as under the
JAX package's optax.MultiSteps (loop.py:9), with `step` counting
micro-steps as the JAX TrainState does. Each micro-step adds the
gradient of loss / k to .grad, so the update sees the mean of the k
micro-batch gradients; a checkpoint taken mid-cycle keeps the .grad
sums, and training resumes mid-cycle.

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
from .optim import lr_multiplier, make_optimizer, set_lr_mult

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Trainer:
    cfg: Config
    task: Any
    train_loader: Callable[[int], Iterable]
    eval_loader: Optional[Callable[[int], Iterable]] = None
    device: Optional[Any] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = self.task.model
        self.model.load_state_dict(self.task.init_state(), assign=True)
        self.model.to(self.device).train()
        self.opt = make_optimizer(self.cfg.optim, self.model,
                                  self.task.entries)
        self.ckpt = CheckpointManager(self.cfg.train.ckpt_dir,
                                      max_to_keep=self.cfg.train.keep_checkpoints)
        self.writer = MetricWriter(self.cfg.train.log_dir)
        self.timer = StepTimer()
        # dropout masks: one generator on the device, seeded from train.seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.cfg.train.seed)
        self.best_result = float("-inf")
        self.start_epoch = 0
        self.step = 0
        if self.cfg.train.resume:
            self._try_resume()

    # -- checkpoint ------------------------------------------------------
    def state(self) -> Dict[str, Any]:
        out = {"model": self.model.state_dict(),
               "optimizer": self.opt.state_dict(), "step": self.step}
        if self.step % self.cfg.optim.gradient_accumulation_steps:
            out["grads"] = {n: p.grad for n, p in
                            self.model.named_parameters()
                            if p.grad is not None}
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
        loss, metrics = self.task.loss_fn(self.model, batch, self.generator)
        (loss / k).backward()
        self.step += 1
        if self.step % k:
            return metrics
        # optax updates every leaf: a parameter the loss does not reach
        # (the pooler under the MLM head) still decays, as under AdamW
        # with a zero gradient (AdamW skips a parameter without one)
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        # clip_by_global_norm_ref (train/optim.py:87): max_norm / (norm + 1e-6)
        torch.nn.utils.clip_grad_norm_(self.model.parameters(),
                                       self.cfg.optim.grad_norm_clip)
        self.opt.step()
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
                self.model.eval()
                score, eval_metrics = self.task.eval_fn(
                    self.model, self.eval_loader(epoch))
                for k, v in eval_metrics.items():
                    self.writer.add_scalar(f"eval/{k}", v, epoch)
                if score > self.best_result:
                    self.best_result = score
            if ((epoch + 1) % self.cfg.train.save_every_epochs == 0
                    or epoch == self.cfg.train.max_epochs - 1
                    or score is not None):
                self.ckpt.save(epoch, self.state(), score=score, metrics={
                    "best_result": self.best_result,
                    "contract": getattr(self.task, "contract", {})})
            logger.info("epoch %d done in %.1fs: %s", epoch,
                        time.time() - t0, last)
        return last
