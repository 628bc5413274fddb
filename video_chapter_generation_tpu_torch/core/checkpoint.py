"""Checkpoints as torch files, with the JAX package's surface
(core/checkpoint.py: save, restore_latest, restore_raw, metrics_for,
max_to_keep). Each save writes one file `ckpt_<epoch>.pt` holding the
state dict the caller passes (model, optimizer, step), the epoch and the
metrics (score, best result and the core/contract.py contract). Orbax
checkpoints of the JAX package are not read. Retention keeps the newest
max_to_keep files. Files are written to a temporary name and renamed, so
a reader never sees half a checkpoint; they load with weights_only=True.
"""

from __future__ import annotations

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

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"ckpt_{epoch}.pt")

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
        path = self._path(epoch)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"epoch": epoch, "state": state, "metrics": m}, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def _load(self, epoch: int) -> Dict[str, Any]:
        return torch.load(self._path(epoch), map_location="cpu",
                          weights_only=True)

    def restore_latest(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        """(epoch, state) of the newest checkpoint, or None."""
        return self.restore_raw()

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
        return dict(self._load(step)["metrics"])
