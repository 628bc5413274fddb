"""The title model from a checkpoint (counterpart of the JAX package's
cli/eval_title.py). Of that CLI, `_restore` (:215-248) is ported, as the
serving CLI needs it; the ROUGE evaluation itself is ROADMAP queue 1
item 11.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.checkpoint import CheckpointManager
from ..core.contract import assert_contract


def _restore(cfg, task) -> Dict[str, torch.Tensor]:
    """The title model's float32 state dict, for any title family (the
    task's config says which) and for the plain (TitleGenTask, model kind
    "title") and vision-conditioned (TitleGenVisionTask, "title_vision")
    models: the best checkpoint in cfg.train.ckpt_dir, else the newest,
    else the task's seeded random weights, with a line saying which. A
    checkpoint of another model kind (the boundary model shares the
    directory in cli/infer_video; a plain title model is no vision one) is
    not restored; the JAX package's restore fails on its tree and falls
    back to random weights the same way. A checkpoint of the task's kind
    whose contract does not match raises ContractMismatch: it never
    degrades to random weights."""
    ckpt = CheckpointManager(cfg.train.ckpt_dir)
    step = ckpt.best_step()
    if step is None:
        print(f"no checkpoint restored (none in {cfg.train.ckpt_dir}): "
              f"random title weights")
        return task.init_state()
    contract = ckpt.metrics_for(step).get("contract") or {}
    kind = contract.get("model_kind", "title")
    if kind != task.contract["model_kind"]:
        print(f"no checkpoint restored (epoch {step} in "
              f"{cfg.train.ckpt_dir} is a {kind} checkpoint): random title "
              f"weights")
        return task.init_state()
    assert_contract(contract, task.contract, context="checkpoint load")
    _, state = ckpt.restore_raw(step)
    print(f"restored checkpoint at epoch {step} (step {state['step']})")
    return state["model"]
