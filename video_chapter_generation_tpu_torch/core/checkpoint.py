"""Checkpoints as torch files, with the JAX package's surface
(core/checkpoint.py: save, restore_latest, restore_best, restore_raw,
metrics_for, max_to_keep). Each save writes `ckpt_<epoch>.json`, the
metrics (score, best result and the core/contract.py contract), then
`ckpt_<epoch>.pt`, the state dict the caller passes (model, optimizer,
step) and the epoch. Orbax checkpoints of the JAX package are not read.
Checkpoints written before the sidecar existed hold their metrics in the
.pt (`"metrics"`); `metrics_for` reads them there when no .json is
beside it, so such a directory restores and trains on.

Under data-parallel training the Trainer gathers the ZeRO-sharded
optimizer state and writes on its primary process only
(train/loop.py), so a file holds what a one-process run writes and
resumes at any process count.

Retention is orbax's under the JAX manager's best_fn (core/checkpoint.py
:31-39, orbax's BestN policy): with more than max_to_keep checkpoints,
keep the max_to_keep best by score, a checkpoint saved without one
counting as -inf; ties keep the newer. The best checkpoint is the last
of that order; `best_step(model_kind)` takes it among the checkpoints
whose contract names that model kind, so one directory can serve a
boundary model and a title model (the JAX package's restores take the
best of any kind, and a title model there falls back to random weights
beside a better-scored boundary checkpoint). Files are written to a temporary name and renamed, so a
reader never sees half a checkpoint; they load with weights_only=True.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 10):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch: int, ext: str = "pt") -> str:
        return os.path.join(self.directory, f"ckpt_{epoch}.{ext}")

    def steps(self) -> List[int]:
        """Saved epochs, oldest first."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, epoch: int, state: Dict[str, Any],
             score: Optional[float] = None,
             metrics: Optional[Dict] = None) -> None:
        m = dict(metrics or {})
        if score is not None:
            m["score"] = float(score)
        path = self._path(epoch, "json")
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(m, f)
        os.replace(tmp, path)
        path = self._path(epoch)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"epoch": epoch, "state": state}, tmp)
        os.replace(tmp, path)
        by_score = self._by_score()
        if len(by_score) > self.max_to_keep:
            for old in by_score[:-self.max_to_keep]:
                os.remove(self._path(old))
                if os.path.exists(self._path(old, "json")):
                    os.remove(self._path(old, "json"))

    def _by_score(self) -> List[int]:
        """Saved epochs from worst to best score (stable: among equal
        scores the older comes first)."""
        return sorted(self.steps(), key=lambda e: self.metrics_for(e).get(
            "score", float("-inf")))

    def best_step(self, model_kind: Optional[str] = None,
                  default_kind: Optional[str] = None) -> Optional[int]:
        """The best-scored epoch; with model_kind, the best of those whose
        contract's model_kind is that kind (a checkpoint without one
        counts as default_kind, and as any kind when that is None)."""
        def fits(e):
            kind = self.model_kind(e) or default_kind
            return kind is None or kind == model_kind

        by_score = [e for e in self._by_score()
                    if model_kind is None or fits(e)]
        return by_score[-1] if by_score else None

    def model_kind(self, step: int) -> Optional[str]:
        """The model_kind of a checkpoint's contract, None without one."""
        return (self.metrics_for(step).get("contract") or {}).get(
            "model_kind")

    def _load(self, epoch: int) -> Dict[str, Any]:
        return torch.load(self._path(epoch), map_location="cpu",
                          weights_only=True)

    def restore_latest(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        """(epoch, state) of the newest checkpoint, or None."""
        return self.restore_raw()

    def restore_best(self, model_kind: Optional[str] = None
                     ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """(epoch, state) of the best-scored checkpoint (of model_kind,
        when given), or None."""
        step = self.best_step(model_kind)
        return None if step is None else self.restore_raw(step)

    def restore_raw(self, step: Optional[int] = None
                    ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """(epoch, state) of the given or newest checkpoint, or None (the
        train_segment --init_streams warm start reads it)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return step, self._load(step)["state"]

    def metrics_for(self, step: int) -> Dict:
        """The metrics saved with a checkpoint (score, contract, ...)."""
        path = self._path(step, "json")
        if not os.path.exists(path):  # the older single-file format
            return dict(self._load(step)["metrics"])
        with open(path) as f:
            return json.load(f)
